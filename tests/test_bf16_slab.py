"""Conservative bf16 child slab test (VORTEX_RT_BF16_SLAB): hits must be
BIT-IDENTICAL to the f32 walk on every mode — the bf16 test runs in
node-local coordinates with +-1-LSB box widening and a 2^-6 relative
pad, so its visit set is a strict SUPERSET of the f32 walk's and the
closest-hit fold (f32 Moller-Trumbore, unchanged) sees every candidate
the f32 walk sees.

Default off: the pad inflates the t-window, which costs extra visits
on small far boxes (docs/ARCHITECTURE.md rule 39; unmeasured on the
GPU).  The knob and this gate stay until the GPU sweep decides it."""

import numpy as np
import pytest

from vortex_rt_tpu.golden.renderer import generate_rays
from vortex_rt_tpu.models.procedural import cornell_box, uv_sphere
from vortex_rt_tpu.models.scene import Scene
from vortex_rt_tpu.ops.traverse_packet import trace_packets
from vortex_rt_tpu.ops.traverse_wide import WideArrays
from vortex_rt_tpu.utils.config import RTConfig


@pytest.fixture(scope="module")
def wa_and_rays():
    sc = Scene()
    for mesh, refl in cornell_box():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    sc.add_instance(sc.add_mesh(uv_sphere((0, -0.3, 0), 0.35, 24, 48)))
    sb = sc.build(RTConfig(flatten=True))
    wa = WideArrays.from_scene(sb, width=8).fuse()
    cam = Scene.framing_camera(sb, 45.0, 1.0)
    o, d = generate_rays(cam, 64, 64)
    return wa, np.asarray(o), np.asarray(d)


def _assert_exact(a, b):
    for f in ("dist", "bx", "by", "tri", "inst"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)))


@pytest.mark.parametrize("fronts", [1, 2])
def test_bf16_slab_camera_parity(wa_and_rays, fronts):
    wa, o, d = wa_and_rays
    h0, s0 = trace_packets(wa, o, d, packet=16, fronts=fronts,
                           bf16_slab=False)
    h1, s1 = trace_packets(wa, o, d, packet=16, fronts=fronts,
                           bf16_slab=True)
    _assert_exact(h0, h1)
    # conservative: the bf16 walk may only OVER-visit
    assert int(s1) >= int(s0)


def test_bf16_slab_incoherent_parity(wa_and_rays):
    wa, _, _ = wa_and_rays
    rng = np.random.default_rng(5)
    o = rng.uniform(-2, 2, (2048, 3)).astype(np.float32)
    d = rng.normal(size=(2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    h0, _ = trace_packets(wa, o, d, packet=16, bf16_slab=False)
    h1, _ = trace_packets(wa, o, d, packet=16, bf16_slab=True)
    _assert_exact(h0, h1)


def test_bf16_slab_axis_rays_parity(wa_and_rays):
    """Zero direction components (eps-reciprocal slab convention) —
    the edge the quantized-outward build rule exists for."""
    wa, _, _ = wa_and_rays
    o = np.tile([[0.1, 0.2, -3.0]], (256, 1)).astype(np.float32)
    d = np.tile([[0.0, 0.0, 1.0]], (256, 1)).astype(np.float32)
    h0, _ = trace_packets(wa, o, d, packet=16, bf16_slab=False)
    h1, _ = trace_packets(wa, o, d, packet=16, bf16_slab=True)
    _assert_exact(h0, h1)


def test_bf16_slab_occlusion_parity(wa_and_rays):
    wa, _, _ = wa_and_rays
    rng = np.random.default_rng(7)
    o = rng.uniform(-2, 2, (1024, 3)).astype(np.float32)
    d = rng.normal(size=(1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.full(1024, 8.0, np.float32)
    h0, _ = trace_packets(wa, o, d, packet=16, t_max=tm, occlusion=True,
                          bf16_slab=False)
    h1, _ = trace_packets(wa, o, d, packet=16, t_max=tm, occlusion=True,
                          bf16_slab=True)
    np.testing.assert_array_equal(np.asarray(h0.dist), np.asarray(h1.dist))
