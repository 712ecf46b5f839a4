"""Bit-identity gates for the round-4 staged bounce-wave levers:

* VORTEX_RT_LIVE_SORT — live-first (stable argsort) bounce-wave
  packetization in engine.wavefront._wave_pipeline.  Packet composition
  changes, but each ray's closest hit is a min-fold over its own
  intersecting candidates with a lexicographic tie-break, so the frame
  must be bit-identical (same argument as straggler compaction,
  docs/ARCHITECTURE.md rule 25).
* VORTEX_RT_COMPACT_DIV — the straggler-compaction round-shrink factor
  in ops.traverse_packet (4 -> widths B/4, B/16, ...; 2 -> B/2, B/4,
  ...).  Compaction only moves whole packets, so any factor is
  bit-identical; low-entry-density waves shed dead width sooner at 2.

Reference semantics being preserved: the RTU repacks divergent
continuations into dense warps (sim/simx/rt_unit.cpp:125-161 pop_warp);
live-first packing is that regrouping applied at wave granularity.
"""
import numpy as np
import pytest

from vortex_rt_tpu.models.scene import RenderParams, Scene
from vortex_rt_tpu.ops.traverse_packet import trace_packets
from vortex_rt_tpu.utils.config import RTConfig


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _cornell_sb():
    from vortex_rt_tpu.models.procedural import cornell_box

    sc = Scene()
    for mesh, refl in cornell_box():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    return sc.build(RTConfig(flatten=True))


def _render(sb, live_sort, compact_div, monkeypatch, pathtrace):
    import vortex_rt_tpu.engine.wavefront as wf
    import vortex_rt_tpu.ops.traverse_packet as tp
    from vortex_rt_tpu.engine.wavefront import WavefrontRenderer

    monkeypatch.setattr(wf, "_LIVE_SORT_DEFAULT", live_sort)
    monkeypatch.setattr(tp, "_COMPACT_DIV_DEFAULT", compact_div)
    r = WavefrontRenderer.from_buffers(sb, RTConfig(flatten=True))
    cam = Scene.framing_camera(sb, 45.0, 1.0)
    # depth 3 + shadow exercises the merged shadow+bounce wave (both
    # permuted halves) AND the trailing unmerged shadow wave
    params = RenderParams(max_depth=3, spp=2, shadow=True,
                          pathtrace=pathtrace)
    img, _ = r.render(cam, params, 48, 48)
    return np.asarray(img)


@pytest.mark.parametrize("pathtrace", [False, True])
def test_live_sort_frame_bit_identical(rng, monkeypatch, pathtrace):
    sb = _cornell_sb()
    base = _render(sb, False, 4, monkeypatch, pathtrace)
    on = _render(sb, True, 4, monkeypatch, pathtrace)
    np.testing.assert_array_equal(base, on)


def test_compact_div_frame_bit_identical(rng, monkeypatch):
    sb = _cornell_sb()
    base = _render(sb, False, 4, monkeypatch, True)
    div2 = _render(sb, False, 2, monkeypatch, True)
    np.testing.assert_array_equal(base, div2)


def test_both_knobs_frame_bit_identical(rng, monkeypatch):
    sb = _cornell_sb()
    base = _render(sb, False, 4, monkeypatch, True)
    both = _render(sb, True, 2, monkeypatch, True)
    np.testing.assert_array_equal(base, both)


def test_compact_div_trace_bit_identical(rng):
    """Raw packet-engine parity across compaction factors, closest-hit
    and mixed occlusion/closest waves, sparse activity masks."""
    import vortex_rt_tpu.ops.traverse_packet as tp

    from vortex_rt_tpu.models.procedural import random_soup

    sc = Scene()
    from vortex_rt_tpu.ops.traverse_wide import WideArrays

    sc.add_instance(sc.add_mesh(random_soup(rng, 600)))
    sb = sc.build(RTConfig(flatten=True))
    wa = WideArrays.from_scene(sb, width=4)
    o = rng.uniform(-6, 6, (2048, 3)).astype(np.float32)
    d = rng.normal(size=(2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    act = rng.uniform(size=2048) < 0.3  # bounce-wave-like density
    tmax = np.full(2048, 8.0, np.float32)
    old = tp._COMPACT_DIV_DEFAULT
    try:
        tp._COMPACT_DIV_DEFAULT = 4
        h4, s4 = trace_packets(wa, o, d, packet=32, active=act)
        hm4, _ = trace_packets(wa, o, d, packet=32, active=act,
                               t_max=tmax, occl_split=1024)
        tp._COMPACT_DIV_DEFAULT = 2
        h2, s2 = trace_packets(wa, o, d, packet=32, active=act)
        hm2, _ = trace_packets(wa, o, d, packet=32, active=act,
                               t_max=tmax, occl_split=1024)
    finally:
        tp._COMPACT_DIV_DEFAULT = old
    for k in ("dist", "bx", "by", "tri", "inst"):
        np.testing.assert_array_equal(np.asarray(getattr(h4, k)),
                                      np.asarray(getattr(h2, k)))
    np.testing.assert_array_equal(np.asarray(hm4.dist),
                                  np.asarray(hm2.dist))


def test_bounce_sort_seg_frame_bit_identical(rng):
    """RTConfig.bounce_sort_seg (segmented direction-octant regrouping
    of bounce waves, round 5): bit-identical frames at any segment size.
    Default off (ARCHITECTURE.md rule 38: it raised the straggler-max
    step count at the config-3 shape; unmeasured on the GPU).  The
    identity argument is packet composition only, same as live_sort
    above."""
    from vortex_rt_tpu.engine.wavefront import WavefrontRenderer
    from vortex_rt_tpu.models.scene import Camera  # noqa: F401

    sb = _cornell_sb()
    cam = Scene.framing_camera(sb, 45.0, 1.0)
    params = RenderParams(max_depth=3, spp=2, shadow=True, pathtrace=True)
    imgs = []
    for seg in (0, 256, 1024):
        r = WavefrontRenderer.from_buffers(
            sb, RTConfig(flatten=True, bounce_sort_seg=seg))
        img, _ = r.render(cam, params, 48, 48)
        imgs.append(np.asarray(img))
    np.testing.assert_array_equal(imgs[0], imgs[1])
    np.testing.assert_array_equal(imgs[0], imgs[2])
