"""Bit-identity gates for the multi-front packet walk
(ops.traverse_packet trace_packets ``fronts`` / RTConfig.bounce_fronts).

``fronts=F`` drains each packet's shared deferred-children stack F
nodes per while-loop iteration through one (F*B,)-row gather — the
gather-latency-hiding lever for incoherent bounce waves (two
independent node rows fetched in ONE gather instead of two chained
ones; ARCHITECTURE.md rule 32).  Visit
ORDER changes (and best_t pruning may lag a sibling front by one
iteration, so visits form a superset), but each ray's result is a
min-fold over its own intersecting candidates with the exact
lexicographic (inst, tri) tie-break — the winner cannot change.  These
tests pin that bit-identity across every traversal mode and through
the full wavefront frame.

Reference semantics preserved: the walk visits the same candidate set
as sim/simx/rt_traversal.cpp:51-165's DFS, just F entries at a time.
"""
import numpy as np
import pytest

from vortex_rt_tpu.models.scene import RenderParams, Scene
from vortex_rt_tpu.ops.traverse_packet import trace_packets
from vortex_rt_tpu.ops.traverse_wide import WideArrays
from vortex_rt_tpu.utils.config import RTConfig


@pytest.fixture(scope="module")
def flat_scene():
    from vortex_rt_tpu.models.procedural import cornell_box

    sc = Scene()
    for mesh, refl in cornell_box():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    return sc.build(RTConfig(flatten=True))


def _wa(sb, width):
    wa = WideArrays.from_scene(sb, width=width)
    return wa.fuse()


def _rays(n, seed=7):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    act = rng.random(n) > 0.3
    tmax = rng.uniform(0.2, 10.0, n).astype(np.float32)
    return o, d, act, tmax


FIELDS = ("dist", "bx", "by", "tri", "inst")


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("mode", ["closest", "occl", "mixed"])
def test_fronts_bit_identical(flat_scene, width, mode):
    import jax.numpy as jnp

    wa = _wa(flat_scene, width)
    o, d, act, tmax = _rays(2048)
    kw = dict(packet=32, active=jnp.asarray(act), t_max=jnp.asarray(tmax))
    if mode == "occl":
        kw["occlusion"] = True
    elif mode == "mixed":
        kw["occl_split"] = 1024
    h1, _ = trace_packets(wa, jnp.asarray(o), jnp.asarray(d), **kw)
    for fronts in (2, 3):
        hf, _ = trace_packets(wa, jnp.asarray(o), jnp.asarray(d),
                              fronts=fronts, **kw)
        for f in FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(h1, f)), np.asarray(getattr(hf, f)),
                err_msg=f"width={width} mode={mode} fronts={fronts} "
                        f"field={f}")


@pytest.mark.parametrize("width", [4, 8])
def test_fronts_unfused_and_stats(flat_scene, width):
    """Non-fused tables take the two-gather path; stats mode runs the
    no-compaction round.  Both must stay bit-identical."""
    import jax.numpy as jnp

    wa = WideArrays.from_scene(flat_scene, width=width)  # not fused
    o, d, act, tmax = _rays(1024, seed=13)
    kw = dict(packet=32, active=jnp.asarray(act), t_max=jnp.asarray(tmax))
    h1, s1 = trace_packets(wa, jnp.asarray(o), jnp.asarray(d),
                           stats=True, **kw)
    h2, s2 = trace_packets(wa, jnp.asarray(o), jnp.asarray(d),
                           stats=True, fronts=2, **kw)
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(h1, f)), np.asarray(getattr(h2, f)))
    # F fronts visit the same nodes (+ a small stale-best_t superset) in
    # ~1/F the iterations; node visits are conserved within 15%
    assert int(s2.steps) < int(s1.steps)
    v1 = int(s1.int_steps) + int(s1.tri_steps)
    v2 = int(s2.int_steps) + int(s2.tri_steps)
    assert v2 <= v1 * 1.15


def test_fronts_alpha_anyhit(flat_scene):
    """In-loop alpha-test any-hit must reject the identical candidate
    set under multi-front scheduling."""
    import jax.numpy as jnp

    from vortex_rt_tpu.models.procedural import cornell_box

    sc = Scene()
    for mesh, refl in cornell_box():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    sb = sc.build(RTConfig(flatten=True))
    wa = WideArrays.from_scene(sb, width=4).with_alpha(sb).fuse()
    o, d, act, tmax = _rays(1024, seed=5)
    kw = dict(packet=32, active=jnp.asarray(act), t_max=jnp.asarray(tmax),
              alpha_ref=0.5)
    h1, _ = trace_packets(wa, jnp.asarray(o), jnp.asarray(d), **kw)
    h2, _ = trace_packets(wa, jnp.asarray(o), jnp.asarray(d), fronts=2,
                          **kw)
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(h1, f)), np.asarray(getattr(h2, f)))


def test_fronts_tlas_fallback(flat_scene):
    """TLAS (non-flat) builds silently fall back to one front."""
    import jax.numpy as jnp

    from vortex_rt_tpu.models.procedural import cornell_box

    sc = Scene()
    for mesh, refl in cornell_box():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    sb = sc.build(RTConfig())  # TLAS build
    wa = WideArrays.from_scene(sb, width=4)
    o, d, act, tmax = _rays(512, seed=3)
    kw = dict(packet=32, active=jnp.asarray(act), t_max=jnp.asarray(tmax))
    h1, s1 = trace_packets(wa, jnp.asarray(o), jnp.asarray(d), **kw)
    h2, s2 = trace_packets(wa, jnp.asarray(o), jnp.asarray(d), fronts=4,
                           **kw)
    assert int(s1) == int(s2)
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(h1, f)), np.asarray(getattr(h2, f)))


@pytest.mark.parametrize("pathtrace", [False, True])
def test_fronts_frame_bit_identical(flat_scene, pathtrace):
    """The full wavefront frame (merged shadow+bounce waves, straggler
    compaction, trailing shadow wave) is bit-identical with
    bounce_fronts=2 — the production adoption gate."""
    from vortex_rt_tpu.engine.wavefront import WavefrontRenderer

    cam = Scene.framing_camera(flat_scene, 45.0, 1.0)
    params = RenderParams(max_depth=3, spp=2, shadow=True,
                          pathtrace=pathtrace)
    imgs = []
    for fronts in (1, 2):
        r = WavefrontRenderer.from_buffers(
            flat_scene, RTConfig(flatten=True, bounce_fronts=fronts))
        img, _ = r.render(cam, params, 48, 48)
        imgs.append(np.asarray(img))
    np.testing.assert_array_equal(imgs[0], imgs[1])
