"""Smoke run of the path tracer on one GPU, at the sizes users render.

    python chip_smoke.py           # every single-card phase, one card
    python chip_smoke.py --multi   # only the 4-card phase and its reference

Phases, each in this one process, each fatal on failure:

* main     — the config-4 deployment through the CLI: Sponza-class atrium
             (260k tris), 1920x1080, spp 2, depth 2, path trace + shadow
             rays, on the default wavefront engine and flattened build;
             then a 2-frame ``render_burst`` and one ``render_stats``
             frame on the same build.  Golden parity on sampled pixels.
* build    — on-device PLOC build of the 69k-tri blob (config 3) and
             on-device LBVH build + refit of the 1M-tri wavy grid
             (config 5), each followed by a 1080p spp 2 frame with
             golden parity.
* anyhit   — in-loop alpha any-hit (config 6) on the textured atrium at
             512x512, spp 2, golden parity (the oracle applies the same
             alpha predicate).
* megakernel — ``cli --engine megakernel --compare`` on cornell 256x256.
* multi    — (``--multi`` only) tile-parallel wavefront frame of the
             atrium at 1080p over a 4-card mesh against the single-card
             frame, and scene-sharded frames (dp=2 x sp=2, both
             schedules) against the replicated one.

Every metric is printed on its own line; the last line of standard output
is one JSON object, ``{"ok": true, "device": {...}}``, printed only when
every phase passed.  Exits non-zero without it when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# sampled-pixel golden parity gate (tests/test_scale.py, parallel/tiles.py)
PARITY_RMSE = 3e-3
PARITY_PIXELS = 16
# tile-parallel vs single-card pixel rule (tests/test_parallel.py)
TILE_PIX_TOL, TILE_BAD_FRAC = 1e-4, 0.02
# scene-sharded vs replicated image (parallel/tiles.py dryrun)
SHARD_RMSE = 1e-5

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "build", "smoke")


def log(name: str, **kv) -> None:
    """One metric line: ``phase: key=value ...``."""
    print(f"{name}: " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def result_line(device: dict) -> str:
    """The contract's last line: exactly ``ok`` and ``device``."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}})


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def phase_main(model="atrium", w=1920, h=1080, spp=2, depth=2):
    """Config-4 deployment through the CLI, then burst + stats."""
    from vortex_rt_tpu import cli
    from vortex_rt_tpu.golden.renderer import frame_parity

    os.makedirs(OUT_DIR, exist_ok=True)
    res = cli.run(["-m", model, "-w", str(w), "-H", str(h), "-s", str(spp),
                   "-d", str(depth), "--pathtrace", "--shadow",
                   "-o", os.path.join(OUT_DIR, f"main_{model}.ppm")])
    r, cam, params = res.renderer, res.cam, res.params
    _check(np.isfinite(res.img).all() and res.img.shape == (h, w, 3),
           f"main: bad image {res.img.shape}")
    # the CLI's first render compiled the frame; a second one is steady
    (_, steady_s) = _timed(lambda: r.render(cam, params, w, h))
    compile_s = res.seconds - steady_s
    # burst: first call compiles the 2-frame program, second is timed
    n = 2
    _, burst_compile_s = _timed(lambda: r.render_burst(
        cam, params, w, h, n_frames=n, seed0=1, rays_only=True))
    rays, burst_s = _timed(lambda: r.render_burst(
        cam, params, w, h, n_frames=n, seed0=3, rays_only=True))
    ms_frame = burst_s * 1e3 / n
    stats = r.perf_trace(cam, params, w, h)
    # per-wave dicts carry each wave's loop iterations
    iters = sum(v["steps"] for v in stats.values() if isinstance(v, dict))
    rmse = frame_parity(res.sb, cam, params, res.img, w, h,
                        n=PARITY_PIXELS)
    out = dict(compile_s=compile_s, first_render_s=res.seconds,
               steady_render_ms=steady_s * 1e3,
               burst_compile_s=burst_compile_s, ms_per_frame=ms_frame,
               mrays_per_s=rays / burst_s / 1e6, rays_per_frame=rays / n,
               iterations_per_frame=iters,
               ms_per_iteration=ms_frame / max(iters, 1),
               parity_rmse=rmse)
    for k, v in out.items():
        log("main", **{k: v})
    _check(rays > 0 and iters > 0, "main: no rays or loop iterations")
    _check(rmse < PARITY_RMSE, f"main: parity rmse {rmse}")
    return out


def _flat_scene(model):
    from vortex_rt_tpu import cli
    from vortex_rt_tpu.utils.config import RTConfig

    cfg = RTConfig(flatten=True)
    return cfg, cli.build_scene(model).build(cfg)


def _pt_frame(name, sb, cfg, wa, w, h, spp, depth):
    """One path-traced frame on a device-built tree + golden parity."""
    import dataclasses

    from vortex_rt_tpu.engine.wavefront import WavefrontRenderer
    from vortex_rt_tpu.golden.renderer import frame_parity
    from vortex_rt_tpu.models.scene import RenderParams, Scene

    r = WavefrontRenderer.from_buffers(sb, cfg)
    r = dataclasses.replace(r, wa=wa.fuse() if cfg.fused_rows else wa)
    cam = Scene.framing_camera(sb, 45.0, w / h)
    params = RenderParams(max_depth=depth, spp=spp, shadow=True,
                          pathtrace=True)
    (img, rays), first_s = _timed(lambda: r.render(cam, params, w, h))
    (img, rays), frame_s = _timed(lambda: r.render(cam, params, w, h))
    _check(np.isfinite(img).all() and rays > 0, f"{name}: bad frame")
    rmse = frame_parity(sb, cam, params, img, w, h, n=PARITY_PIXELS)
    log(name, frame_compile_s=first_s - frame_s, frame_ms=frame_s * 1e3,
        mrays_per_s=rays / frame_s / 1e6, parity_rmse=rmse)
    _check(rmse < PARITY_RMSE, f"{name}: parity rmse {rmse}")
    return dict(frame_ms=frame_s * 1e3, parity_rmse=rmse)


def phase_build(ploc_model="bunny", lbvh_model="waves", w=1920, h=1080,
                spp=2, depth=2):
    """On-device PLOC build (config 3) and LBVH build + refit (config 5),
    each followed by a golden-gated frame on the device-built tree."""
    import jax
    import jax.numpy as jnp

    from vortex_rt_tpu.accel.lbvh import (
        build_lbvh_topo, compact_plan, pad_tris, refit_lbvh,
        wide_arrays_from_lbvh,
    )
    from vortex_rt_tpu.accel.ploc import build_wide_ploc

    out = {}
    # ---- PLOC (config 3)
    cfg, sb = _flat_scene(ploc_model)

    def ploc():
        wa = build_wide_ploc(sb, leaf_size=cfg.max_leaf_tris,
                             width=cfg.bvh_width)
        jax.block_until_ready(wa.nodes)
        return wa

    _, first_s = _timed(ploc)
    wa, build_s = _timed(ploc)
    log("build.ploc", tris=sb.num_tris, compile_s=first_s - build_s,
        build_ms=build_s * 1e3)
    out["ploc"] = dict(build_ms=build_s * 1e3, **_pt_frame(
        "build.ploc", sb, cfg, wa, w, h, spp, depth))

    # ---- LBVH build + refit (config 5)
    cfg, sb = _flat_scene(lbvh_model)
    leaf, width = cfg.max_leaf_tris, cfg.bvh_width
    dv = [jnp.asarray(v) for v in pad_tris(sb.v0, sb.v1, sb.v2, leaf)]

    def lbvh():
        lb, topo = build_lbvh_topo(*dv, leaf_size=leaf, width=width)
        jax.block_until_ready(lb.nodes)
        return topo

    _, first_s = _timed(lbvh)
    topo, build_s = _timed(lbvh)
    pool_rows, leaf_rows, surv_idx = compact_plan(topo)
    base_y = [v[:, 1] for v in dv]

    @jax.jit
    def refit(topo, dv, base_y, surv_idx, t):
        # ripple in y; t=0 reproduces the host geometry bitwise, so the
        # t=0 tree renders exactly what the golden oracle traces
        def move(v, y0):
            def field(t_):
                return 0.3 * jnp.sin(0.7 * v[:, 0] + 2.1 * t_) \
                    * jnp.cos(0.5 * v[:, 2] - 1.3 * t_)
            return v.at[:, 1].set(y0 + field(t) - field(jnp.float32(0.0)))

        return refit_lbvh(topo, *[move(v, y) for v, y in zip(dv, base_y)],
                          leaf_size=leaf, width=width, pool_rows=pool_rows,
                          leaf_rows=leaf_rows, surv_idx=surv_idx)

    def refit_at(t):
        lb = refit(topo, dv, base_y, surv_idx, jnp.float32(t))
        jax.block_until_ready(lb.nodes)
        return lb

    _, refit_first_s = _timed(lambda: refit_at(0.0))
    _, refit_s = _timed(lambda: refit_at(0.1))
    lb = refit_at(0.0)
    wa = wide_arrays_from_lbvh(lb, leaf, width=width)
    log("build.lbvh", tris=sb.num_tris, compile_s=first_s - build_s,
        build_ms=build_s * 1e3, refit_compile_s=refit_first_s - refit_s,
        refit_ms=refit_s * 1e3)
    out["lbvh"] = dict(build_ms=build_s * 1e3, refit_ms=refit_s * 1e3,
                       **_pt_frame("build.lbvh", sb, cfg, wa, w, h, spp,
                                   depth))
    return out


def phase_anyhit(model="atrium_tex", w=512, h=512, spp=2, depth=2,
                 threshold=0.30):
    """In-loop alpha any-hit frame (config 6) + golden parity with the
    oracle applying the same alpha predicate."""
    from vortex_rt_tpu.engine.shaders import ShaderTable, alpha_test_anyhit
    from vortex_rt_tpu.engine.wavefront import WavefrontRenderer
    from vortex_rt_tpu.golden.renderer import alpha_keep, frame_parity
    from vortex_rt_tpu.models.scene import RenderParams, Scene

    cfg, sb = _flat_scene(model)
    table = ShaderTable(anyhit=alpha_test_anyhit(threshold))
    r = WavefrontRenderer.from_buffers(sb, cfg, table)
    _check(r.wa.alpha_rows is not None, "anyhit: no in-loop alpha tables")
    cam = Scene.framing_camera(sb, 45.0, w / h)
    params = RenderParams(max_depth=depth, spp=spp, shadow=True,
                          light_pos=(0.0, 8.0, 0.0))
    (img, rays), first_s = _timed(lambda: r.render(cam, params, w, h))
    (img, rays), frame_s = _timed(lambda: r.render(cam, params, w, h))
    _check(np.isfinite(img).all() and rays > 0, "anyhit: bad frame")
    rmse = frame_parity(sb, cam, params, img, w, h, n=PARITY_PIXELS,
                        keep=alpha_keep(sb, threshold))
    log("anyhit", tris=sb.num_tris, compile_s=first_s - frame_s,
        frame_ms=frame_s * 1e3, mrays_per_s=rays / frame_s / 1e6,
        parity_rmse=rmse)
    _check(rmse < PARITY_RMSE, f"anyhit: parity rmse {rmse}")
    return dict(frame_ms=frame_s * 1e3, parity_rmse=rmse)


def phase_megakernel(model="cornell", w=256, h=256):
    """The binary-BVH megakernel engine against the golden oracle."""
    from vortex_rt_tpu import cli

    os.makedirs(OUT_DIR, exist_ok=True)
    res = cli.run(["-m", model, "-w", str(w), "-H", str(h),
                   "--engine", "megakernel", "--compare",
                   "-o", os.path.join(OUT_DIR, f"mk_{model}.ppm")])
    _check(bool(res.compare_ok), f"megakernel: COMPARE failed "
           f"(rmse {res.compare_rmse})")
    return dict(rmse=res.compare_rmse)


def phase_multi(devices, model="atrium", w=1920, h=1080, spp=1, depth=2):
    """Tile-parallel and scene-sharded frames over ``devices`` (4 cards)
    against the single-card frame and the replicated frame."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from vortex_rt_tpu import cli
    from vortex_rt_tpu.engine.megakernel import CameraArrays, LightArrays
    from vortex_rt_tpu.engine.wavefront import WavefrontRenderer
    from vortex_rt_tpu.models.scene import RenderParams, Scene
    from vortex_rt_tpu.ops.shade_lanes import ShadeArrays
    from vortex_rt_tpu.ops.traverse_wide import WideArrays
    from vortex_rt_tpu.parallel.shards import render_sharded
    from vortex_rt_tpu.parallel.tiles import make_tiled_wavefront

    n = len(devices)
    sc = cli.build_scene(model)
    sb = sc.build()
    cam = Scene.framing_camera(sb, 45.0, w / h)
    params = RenderParams(max_depth=depth, spp=spp, shadow=True)

    # ---- tile-parallel: scene tables replicated onto every card
    mesh = Mesh(np.array(devices), ("tiles",))
    rep = NamedSharding(mesh, P())
    args = jax.device_put(
        (WideArrays.from_scene(sb), ShadeArrays.from_scene(sb),
         CameraArrays.from_camera(cam), LightArrays.from_params(params)),
        rep)
    for leaf in jax.tree.leaves(args):
        held = {s.device for s in leaf.addressable_shards}
        _check(held == set(devices),
               f"multi: a scene table sits on {len(held)} of {n} cards")
    step = make_tiled_wavefront(mesh, w, h, depth, spp, chunk=1024,
                                shadow=True)

    def tiled():
        img, total = step(*args)
        return np.asarray(img), int(total)

    _, first_s = _timed(tiled)
    (img_t, rays_t), tiled_s = _timed(tiled)
    r = WavefrontRenderer.from_buffers(sb)
    (img_1, rays_1), _ = _timed(lambda: r.render(cam, params, w, h))
    (img_1, rays_1), single_s = _timed(lambda: r.render(cam, params, w, h))
    bad = float((np.abs(img_t - img_1).max(-1) > TILE_PIX_TOL).mean())
    log("multi.tiles", cards=n, compile_s=first_s - tiled_s,
        frame_ms=tiled_s * 1e3, single_card_ms=single_s * 1e3,
        mrays_per_s=rays_t / tiled_s / 1e6, pixels_off=bad)
    _check(rays_t == rays_1, f"multi: rays {rays_t} vs {rays_1}")
    _check(bad < TILE_BAD_FRAC, f"multi: {bad} of pixels differ")

    # ---- scene-sharded, dp=n/2 x sp=2, against the replicated image
    mesh2 = Mesh(np.array(devices).reshape(n // 2, 2), ("dp", "sp"))
    for schedule in ("replicate", "alltoall"):
        def sharded(schedule=schedule):
            return render_sharded(sc, cam, params, w, h, n_shards=2,
                                  mesh=mesh2, schedule=schedule)
        _, first_s = _timed(sharded)
        (img_s, rays_s), sharded_s = _timed(sharded)
        rmse = float(np.sqrt(((img_s - img_t) ** 2).mean()))
        # render_sharded re-partitions and re-builds the shards on the
        # host every call, so this is a call time, not a frame time
        log(f"multi.sharded.{schedule}", cards=n,
            compile_s=first_s - sharded_s, call_ms=sharded_s * 1e3,
            rmse_vs_replicated=rmse)
        _check(np.isfinite(img_s).all() and rays_s >= w * h,
               f"multi.sharded.{schedule}: bad frame")
        _check(rmse < SHARD_RMSE, f"multi.sharded.{schedule}: rmse {rmse}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-card tile-parallel and sharded "
                         "phase and the single-card frame it is compared "
                         "with")
    ap.add_argument("--phases", default="main,build,anyhit,megakernel",
                    help="comma list of single-card phases to run")
    a = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 1

    from vortex_rt_tpu.runtime.device import card_info
    from vortex_rt_tpu.utils.cache import enable_persistent_cache

    log("device", kind=devs[0].device_kind, count=len(devs),
        jax=jax.__version__, xla_flags=repr(os.environ.get("XLA_FLAGS", "")))
    print(card_info(), flush=True)
    enable_persistent_cache()

    if a.multi:
        _check(len(devs) >= 4, f"--multi needs 4 cards, have {len(devs)}")
        used = devs[:4]
        _, s = _timed(lambda: phase_multi(used))
        log("phase", phase="multi", seconds=s)
    else:
        used = devs[:1]
        fns = dict(main=phase_main, build=phase_build, anyhit=phase_anyhit,
                   megakernel=phase_megakernel)
        for name in a.phases.split(","):
            _, s = _timed(fns[name])
            log("phase", phase=name, seconds=s)
    print(result_line(dict(platform=used[0].platform,
                           kind=used[0].device_kind, count=len(used))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
