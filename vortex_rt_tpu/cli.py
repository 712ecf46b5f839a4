"""Command-line renderer.

Mirrors the reference app CLI (tests/regression/raytracing/main.cpp:49-102):
``-m model -w width -h height -s spp -d depth -c (cpu golden) -o output``.
``-m`` accepts an .obj path or a builtin procedural scene name
(cornell / sphere / soup).  ``-c`` runs the NumPy golden renderer instead of
the device path — the raycast ``-c`` analog.

Usage:  python -m vortex_rt_tpu.cli -m cornell -w 256 -h 256 -o out.ppm
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Any, Optional

import numpy as np


def build_scene(model: str):
    from vortex_rt_tpu.models.procedural import cornell_box, random_soup, uv_sphere
    from vortex_rt_tpu.models.scene import Scene

    sc = Scene()
    if model == "cornell":
        for mesh, refl in cornell_box():
            i = sc.add_mesh(mesh)
            sc.add_instance(i, reflectivity=refl)
    elif model == "sphere":
        sc.add_mesh(uv_sphere((0, 0, 0), 1.0, 24, 48))
    elif model == "soup":
        sc.add_mesh(random_soup(np.random.default_rng(0), 2000))
    elif model in ("bunny", "atrium", "atrium_tex", "waves"):
        # BASELINE scale-ladder stand-ins (the reference tree is missing
        # Sponza/sponza.obj and has no bunny asset — see models.bigscenes)
        from vortex_rt_tpu.models import bigscenes

        if model == "bunny":
            sc.add_mesh(bigscenes.blob(n=187))
        elif model == "atrium":
            for mesh, refl in bigscenes.atrium():
                sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
        elif model == "atrium_tex":
            # the reference's shipped textures through the asset path
            for mesh, refl in bigscenes.textured_atrium():
                sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
        else:
            sc.add_mesh(bigscenes.wavy_grid())
    elif all(m.strip().endswith(".obj") for m in model.split(",")):
        # one or more OBJ files; multiple get arranged on a circle like
        # the reference (scene.cpp arrangeMeshesAroundY)
        from vortex_rt_tpu.io.obj import load_obj

        names = [m.strip() for m in model.split(",")]
        for name in names:
            mi = sc.add_mesh(load_obj(name))
            sc.add_instance(mi)
        if len(names) > 1:
            sc.arrange_around_y()
    else:
        raise SystemExit(f"unknown model {model!r}")
    return sc


@dataclasses.dataclass
class CliRun:
    """What one CLI render produced, for in-process callers (``run``)."""

    sb: Any                 # host SceneBuffers the device path traced
    cam: Any                # Camera
    params: Any             # RenderParams
    renderer: Any           # device renderer (None for the -c golden path)
    img: np.ndarray         # (H, W, 3) float radiance
    nrays: int
    seconds: float          # first render, compilation included
    compare_rmse: Optional[float] = None   # set by --compare
    compare_ok: Optional[bool] = None


def _backend_live() -> bool:
    """Whether this process already holds a JAX backend (and so, on a
    GPU host, most of the card's memory)."""
    if "jax" not in sys.modules:
        return False
    from jax._src import xla_bridge

    return xla_bridge.backends_are_initialized()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-m", "--model", default="cornell")
    ap.add_argument("-w", "--width", type=int, default=256)
    ap.add_argument("-H", "--height", type=int, default=256)
    ap.add_argument("-s", "--spp", type=int, default=1)
    ap.add_argument("-d", "--depth", type=int, default=2)
    ap.add_argument("-c", "--cpu", action="store_true",
                    help="render with the NumPy golden path (oracle)")
    ap.add_argument("-o", "--output", default="output.ppm")
    ap.add_argument("--vfov", type=float, default=45.0)
    ap.add_argument("--engine", choices=("megakernel", "wavefront"),
                    default="wavefront")
    ap.add_argument("--perf", action="store_true", help="print perf counters")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome/Perfetto trace JSON of the render")
    ap.add_argument("--scope-out", default=None, metavar="FILE",
                    help="frame logic-analyzer trace (scope analog): "
                         "per-stage ms spans + per-wave PerfStats "
                         "counter tracks on one Perfetto timeline")
    ap.add_argument("--shadow", action="store_true",
                    help="occlusion-tested direct lighting (shadow rays)")
    ap.add_argument("--pathtrace", action="store_true",
                    help="path-traced integrator (BASELINE configs 3-4) "
                         "instead of the Whitted closest shader")
    ap.add_argument("--bilinear", action="store_true",
                    help="bilinear texture filtering (texSampleBi)")
    ap.add_argument("--burst", type=int, default=0, metavar="N",
                    help="render N frames in one dispatch and report "
                         "sustained Mrays/s (the animation/throughput API)")
    ap.add_argument("--accum", type=int, default=0, metavar="N",
                    help="average N progressive passes (high-spp renders "
                         "without multiplying pool memory)")
    ap.add_argument("--ladder", default=None, metavar="CONFIGS",
                    help="run the BASELINE config ladder (e.g. '1,2,3') "
                         "and exit — see tools/bench_ladder.py")
    ap.add_argument("--compare", action="store_true",
                    help="also render on the CPU golden oracle and report "
                         "the pixel RMSE (the reference's -c cross-check)")
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.ladder is not None:
        # one-line launch for the BASELINE configs (main.cpp's app IS its
        # CLI; ladder configs are the flagship feature matrix).  The
        # ladder runs in a child process, which needs the card to itself:
        # a JAX process reserves most of the card's memory at start-up.
        if _backend_live():
            ap.error("--ladder must start from a process that has not "
                     "initialised JAX (the child needs the card)")
        import pathlib
        import subprocess

        root = pathlib.Path(__file__).resolve().parents[1]
        return subprocess.call(
            [sys.executable, str(root / "tools" / "bench_ladder.py"),
             "--configs", args.ladder])
    _run(ap, args)
    return 0


def run(argv=None) -> CliRun:
    """Parse ``argv`` exactly like ``main`` and render in this process;
    returns the scene, renderer, image and timing (``--ladder`` is not
    accepted here)."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.ladder is not None:
        ap.error("--ladder runs only through main()")
    return _run(ap, args)


def _run(ap: argparse.ArgumentParser, args) -> CliRun:
    for name in ("width", "height", "spp", "depth"):
        if getattr(args, name) < 1:
            ap.error(f"--{name} must be >= 1")

    from vortex_rt_tpu.models.scene import RenderParams, Scene
    from vortex_rt_tpu.utils.image import write_ppm

    tracer = None
    if args.trace_out:
        from vortex_rt_tpu.utils.trace import enable_tracing

        tracer = enable_tracing()

    from vortex_rt_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    sc = build_scene(args.model)
    # the wavefront device path traces the flattened single-BVH build
    # (RTConfig.flatten): instance transforms baked at build time, no
    # instance nodes in the traversal loop.  The megakernel engine and
    # the golden oracle keep the TLAS layout they were written against.
    flatten = args.engine == "wavefront" and not args.cpu
    from vortex_rt_tpu.utils.config import RTConfig

    sb = sc.build(RTConfig(flatten=flatten))
    aspect = args.width / args.height
    cam = Scene.framing_camera(sb, args.vfov, aspect, zoom=1.0)
    params = RenderParams(spp=args.spp, max_depth=args.depth,
                          shadow=args.shadow, pathtrace=args.pathtrace)

    r = None
    t0 = time.perf_counter()
    if args.cpu:
        if args.pathtrace:
            from vortex_rt_tpu.golden.renderer import render_golden_pt

            img = render_golden_pt(sb, cam, params, args.width,
                                   args.height).reshape(
                args.height, args.width, 3)
        else:
            from vortex_rt_tpu.golden.renderer import render_golden

            img = render_golden(sb, cam, params, args.width, args.height)
        nrays = args.width * args.height * args.depth
    else:
        if args.engine == "megakernel":
            from vortex_rt_tpu.engine.megakernel import MegakernelRenderer

            r = MegakernelRenderer.from_buffers(sb)
        else:
            from vortex_rt_tpu.engine.wavefront import WavefrontRenderer
            from vortex_rt_tpu.utils.config import RTConfig

            cfg = RTConfig(
                tex_filter="bilinear" if args.bilinear else "point")
            r = WavefrontRenderer.from_buffers(sb, cfg)
        if args.burst > 0 and args.engine == "wavefront":
            img, nrays = r.render_burst(cam, params, args.width,
                                        args.height, n_frames=args.burst)
        elif args.accum > 0 and args.engine == "wavefront":
            img, nrays = r.render_accum(cam, params, args.width,
                                        args.height, n_passes=args.accum)
        else:
            img, nrays = r.render(cam, params, args.width, args.height)
    dt = time.perf_counter() - t0

    write_ppm(args.output, np.clip(img, 0, 1))
    mrays = nrays / dt / 1e6
    print(f"rendered {args.width}x{args.height} spp={args.spp} depth={args.depth} "
          f"model={args.model} engine={'cpu' if args.cpu else args.engine}: "
          f"{dt*1e3:.1f} ms, {nrays} rays, {mrays:.2f} Mrays/s -> {args.output}")
    out = CliRun(sb=sb, cam=cam, params=params, renderer=r, img=img,
                 nrays=int(nrays), seconds=dt)
    if args.compare and not args.cpu:
        from vortex_rt_tpu.golden.renderer import (
            render_golden, render_golden_pt,
        )
        from vortex_rt_tpu.utils.image import rmse

        if args.pathtrace:
            if args.accum > 0:
                # replay the accumulation structure: n passes of spp
                # samples stratified over spp*n (render_accum semantics)
                total = args.spp * args.accum
                gold = sum(
                    render_golden_pt(sb, cam, params, args.width,
                                     args.height, spp=args.spp,
                                     total_spp=total, seed=s)
                    for s in range(args.accum)) / args.accum
                gold = gold.reshape(args.height, args.width, 3)
            else:
                gold = render_golden_pt(sb, cam, params, args.width,
                                        args.height).reshape(
                    args.height, args.width, 3)
        else:
            gold = render_golden(sb, cam, params, args.width, args.height)
        err = rmse(np.clip(img, 0, 1), np.clip(gold, 0, 1))
        bad = (np.abs(np.clip(img, 0, 1)
                      - np.clip(gold, 0, 1)).max(-1) > 1 / 255).mean()
        # isolated exact-tie seam pixels may legitimately differ between
        # compilations (see tests/test_megakernel.py); the gate is RMSE
        # or, failing that, <1% differing pixels
        ok = bool(err <= 2e-3 or bad < 0.01)
        out.compare_rmse, out.compare_ok = float(err), ok
        print(f"COMPARE: rmse={err:.6f} pixels_off={bad:.5f} "
              f"({'PASS' if ok else 'FAIL'}: rmse<=2e-3 or <1% seam px)")
    if args.perf:
        # vx_dump_perf analog: scene + run statistics
        print(f"PERF: tris={sb.num_tris} instances={sb.num_instances} "
              f"bvh_nodes={sb.bvh_min.shape[0]} tlas_nodes={sb.tlas_min.shape[0]} "
              f"rays={nrays} wall_ms={dt*1e3:.1f} mrays_per_s={mrays:.3f}")
        if not args.cpu and args.engine == "wavefront":
            # RTU PerfStats analog (rt_unit.h:15-45): primary-trace
            # divergence/occupancy profile from the packet engine
            for k, v in r.perf_trace(cam, params, args.width,
                                     args.height).items():
                print(f"PERF.trace: {k}={v}")
    if tracer is not None:
        tracer.save(args.trace_out)
        print(f"trace -> {args.trace_out}")
    if args.scope_out and not args.cpu and args.engine == "wavefront":
        r.scope_trace(cam, params, args.width,
                      args.height).save(args.scope_out)
        print(f"scope -> {args.scope_out}")
    return out


if __name__ == "__main__":
    sys.exit(main())
