"""Runtime layer: driver API (vortex.h analog) + native C++ builder."""

import numpy as np
import pytest

from vortex_rt_tpu.accel.bvh2 import build_bvh2
from vortex_rt_tpu.models.procedural import random_soup
from vortex_rt_tpu.runtime import native
from vortex_rt_tpu.runtime.device import (
    VX_DCR_BASE_RTX_TLAS_PTR, Device, DeviceError, dev_open,
)


def test_device_open_and_buffers(rng):
    dev = dev_open("cpu")
    assert dev.platform == "cpu"
    x = rng.standard_normal((64, 3)).astype(np.float32)
    dev.copy_to_dev("tri", x)
    np.testing.assert_array_equal(dev.copy_from_dev(dev.buffer("tri")), x)
    assert dev.mem_info()["tri"] == x.nbytes
    with pytest.raises(DeviceError):
        dev.buffer("nope")


def test_device_dcr_and_kernel_lifecycle(rng):
    dev = dev_open("cpu")
    dev.dcr_write(VX_DCR_BASE_RTX_TLAS_PTR, "tlas")
    assert dev.dcr_read(VX_DCR_BASE_RTX_TLAS_PTR) == "tlas"
    with pytest.raises(DeviceError):
        dev.dcr_read(0x999)

    import jax.numpy as jnp

    dev.upload_kernel("double", lambda x: x * 2.0)
    x = dev.copy_to_dev("x", rng.standard_normal(16).astype(np.float32))
    with pytest.raises(DeviceError):
        dev.ready_wait()  # nothing running
    dev.start("double", x)
    with pytest.raises(DeviceError):
        dev.start("double", x)  # busy
    out = dev.ready_wait()
    np.testing.assert_allclose(np.asarray(out), np.asarray(x) * 2.0)
    perf = dev.dump_perf()
    assert perf["kernels_launched"] == 1
    assert perf["uploads"] == 1
    with pytest.raises(DeviceError):
        dev.start("missing", x)


@pytest.mark.skipif(not native.available(), reason="native lib not built")
def test_native_builder_matches_python(rng):
    m = random_soup(rng, 500)
    bp = build_bvh2(m.v0, m.v1, m.v2)
    bn = native.build_bvh2_native(m.v0, m.v1, m.v2)
    # identical permutation domain + full coverage
    assert np.array_equal(np.sort(bn.tri_idx), np.arange(500))
    # structural validity: every leaf covers its slots, children adjacent
    covered = np.zeros(500, np.int32)
    for i in range(bn.num_nodes):
        if bn.tri_count[i] > 0:
            covered[bn.left_first[i] : bn.left_first[i] + bn.tri_count[i]] += 1
        else:
            assert 0 < bn.left_first[i] < bn.num_nodes - 1
    assert (covered == 1).all()
    # same algorithm => near-identical tree quality and size
    assert abs(bn.num_nodes - bp.num_nodes) <= max(4, 0.05 * bp.num_nodes)
    assert bn.sah_cost() <= bp.sah_cost() * 1.1


@pytest.mark.skipif(not native.available(), reason="native lib not built")
def test_native_builder_traversal_parity(rng):
    """Hits through a native-built tree match the brute-force oracle."""
    from vortex_rt_tpu.golden.renderer import brute_force_hits
    from vortex_rt_tpu.models.scene import Scene
    from vortex_rt_tpu.ops.traverse_wide import WideArrays, trace_rays_wide
    from vortex_rt_tpu.utils.config import LARGE_FLOAT, RTConfig

    sc = Scene()
    sc.add_mesh(random_soup(rng, 300))
    sb = sc.build(RTConfig(use_native_build=True))
    wa = WideArrays.from_scene(sb)
    o = rng.uniform(-14, 14, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    hits, _, _ = trace_rays_wide(wa, o, d)
    ref = brute_force_hits(o, d, sb)
    np.testing.assert_array_equal(np.asarray(hits.dist) < LARGE_FLOAT,
                                  ref["dist"] < LARGE_FLOAT)
    h = ref["dist"] < LARGE_FLOAT
    np.testing.assert_allclose(np.asarray(hits.dist)[h], ref["dist"][h],
                               rtol=2e-4)


@pytest.mark.skipif(not native.available(), reason="native lib not built")
def test_native_builder_speed(rng):
    """The native builder should beat the NumPy one on a real mesh size."""
    import time

    m = random_soup(rng, 30_000)
    t0 = time.perf_counter()
    native.build_bvh2_native(m.v0, m.v1, m.v2)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_bvh2(m.v0, m.v1, m.v2)
    t_python = time.perf_counter() - t0
    assert t_native < t_python, (t_native, t_python)


def test_tracer_chrome_format(tmp_path):
    from vortex_rt_tpu.utils.trace import Tracer

    t = Tracer()
    with t.span("build", tris=10):
        with t.span("blas"):
            pass
    t.counter("rays", alive=42)
    t.instant("done")
    out = tmp_path / "trace.json"
    t.save(str(out))
    import json

    data = json.loads(out.read_text())
    names = [e["name"] for e in data["traceEvents"]]
    assert names == ["blas", "build", "rays", "done"]
    assert all("ts" in e for e in data["traceEvents"])
    spans = [e for e in data["traceEvents"] if e["ph"] == "X"]
    assert all(e["dur"] >= 0 for e in spans)


def test_cli_perf_and_trace(tmp_path, capsys):
    from vortex_rt_tpu import cli

    out = tmp_path / "o.ppm"
    tr = tmp_path / "t.json"
    rc = cli.main(["-m", "sphere", "-w", "16", "-H", "16", "-d", "1",
                   "--engine", "wavefront", "--perf",
                   "--trace-out", str(tr), "-o", str(out)])
    assert rc == 0
    assert out.exists() and tr.exists()
    text = capsys.readouterr().out
    assert "PERF:" in text and "mrays_per_s=" in text


def test_cli_compare_flag(tmp_path, capsys):
    from vortex_rt_tpu import cli

    rc = cli.main(["-m", "sphere", "-w", "16", "-H", "16", "-d", "1",
                   "--compare", "-o", str(tmp_path / "o.ppm")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "COMPARE: rmse=" in out and "PASS" in out


def test_cli_scope_trace(tmp_path):
    """Scope analog (runtime/common/scope.cpp:37-216): one timeline with
    per-stage ms spans AND per-wave PerfStats counter tracks."""
    import json

    from vortex_rt_tpu import cli

    sc = tmp_path / "scope.json"
    rc = cli.main(["-m", "sphere", "-w", "16", "-H", "16", "-d", "2",
                   "--engine", "wavefront", "--scope-out", str(sc),
                   "-o", str(tmp_path / "o.ppm")])
    assert rc == 0 and sc.exists()
    data = json.loads(sc.read_text())
    evs = data["traceEvents"]
    spans = {e["name"]: e for e in evs if e["ph"] == "X"}
    # every frame_profile stage appears as a span; trace waves carry
    # their PacketStats in args
    assert "camera" in spans and "trace0" in spans and "trace1" in spans
    assert spans["trace0"]["args"].get("steps", 0) > 0
    # counter tracks step once per instrumented wave
    counters = [e for e in evs if e["ph"] == "C"]
    names = {e["name"] for e in counters}
    assert {"loop_iterations", "live_packet_steps", "live_ray_steps",
            "node_kind_mix"} <= names
    mix = [e for e in counters if e["name"] == "node_kind_mix"]
    assert all({"internal", "triangle", "instance"} <= set(e["args"])
               for e in mix)
    # spans tile a contiguous synthetic timeline
    xs = sorted((e["ts"], e["dur"]) for e in evs if e["ph"] == "X")
    for (t0, d0), (t1, _) in zip(xs, xs[1:]):
        assert abs((t0 + d0) - t1) < 1e-6


@pytest.mark.parametrize("backend", ["gpu", "cuda", "nope"])
def test_dev_open_without_that_backend_raises(backend):
    """No silent fallback: a backend this host lacks (the suite runs on
    CPU only) or does not know raises DeviceError."""
    with pytest.raises(DeviceError):
        dev_open(backend)


def test_require_accelerator_refuses_cpu():
    from vortex_rt_tpu.runtime.device import require_accelerator

    with pytest.raises(DeviceError):
        require_accelerator()
