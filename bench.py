"""Headline benchmark: Mrays/s on the flagship wavefront render path.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", "device",
...}.  Needs a GPU: without one it exits non-zero and prints no number.
Baseline: the reference publishes no RT throughput (BASELINE.md), so
vs_baseline is measured against the BASELINE.json north-star target of
200 Mrays/s/chip.

Measures sustained throughput with the burst API (16 frames per XLA
program — see render_burst in engine/wavefront.py).  Timing includes
dispatch, device compute for every frame, and the final scalar readback.
The full per-config ladder lives in tools/bench_ladder.py.
"""

from __future__ import annotations

import json
import time

NORTH_STAR_MRAYS = 200.0


def bench_scene(flatten: bool = True, max_leaf_tris: int = 4):
    """BASELINE.json config-2 ladder scene: Cornell box + a sphere standing
    in for the teapot, 512x512, 2 bounces, shadow rays.

    ``flatten`` bakes instance transforms into ONE world-space BVH
    (RTConfig.flatten): no instance nodes or local-space lanes in the
    traversal loop.  Hit ids/materials are preserved exactly; the golden
    oracle sees the same flattened buffers, so parity gates still hold."""
    from vortex_rt_tpu.models.procedural import cornell_box, uv_sphere
    from vortex_rt_tpu.models.scene import Scene
    from vortex_rt_tpu.utils.config import RTConfig

    sc = Scene()
    for mesh, refl in cornell_box():
        i = sc.add_mesh(mesh)
        sc.add_instance(i, reflectivity=refl)
    m = sc.add_mesh(uv_sphere((0, -0.3, 0), 0.35, 24, 48))
    sc.add_instance(m)
    return sc.build(RTConfig(flatten=flatten, max_leaf_tris=max_leaf_tris))


def main() -> None:
    from vortex_rt_tpu.runtime.device import card_info, require_accelerator

    device = require_accelerator()

    from vortex_rt_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    import os

    from vortex_rt_tpu.engine.wavefront import WavefrontRenderer
    from vortex_rt_tpu.models.scene import Camera, RenderParams
    from vortex_rt_tpu.utils.config import RTConfig

    # sweepable build knobs
    bvh_width = int(os.environ.get("VORTEX_RT_BVH_WIDTH", "0"))
    leaf = int(os.environ.get("VORTEX_RT_LEAF", "4"))
    sb = bench_scene(max_leaf_tris=leaf)
    width = height = 512
    cam = Camera.look_at([0.05, 0.02, -3.2], [0.0, -0.05, 0.0], [0, 1, 0],
                         45.0, 1.0)
    # spp=2: at spp=1 every frame of a burst is bit-identical (pixel-center
    # rays, deterministic integrator) and XLA legally hoists the frame out
    # of the burst loop, inflating Mrays/s ~n_frames-fold.  spp>=2 makes
    # frames genuinely distinct (seeded stratified jitter).
    params = RenderParams(light_pos=(0, 0.8, -0.5), max_depth=2, shadow=True,
                          spp=2)
    cfg = RTConfig(flatten=True, bvh_width=bvh_width, max_leaf_tris=leaf)
    r = WavefrontRenderer.from_buffers(sb, cfg)

    burst = 16
    t0 = time.perf_counter()
    r.render_burst(cam, params, width, height, n_frames=burst,
                   rays_only=True)   # compile + warm
    compile_s = time.perf_counter() - t0

    reps = 3
    total_rays = 0
    t0 = time.perf_counter()
    for i in range(reps):
        # rays_only: the per-rep sync is one scalar readback
        nrays = r.render_burst(cam, params, width, height,
                               n_frames=burst, seed0=(i + 1) * burst,
                               rays_only=True)
        total_rays += int(nrays)
    dt = time.perf_counter() - t0

    mrays = total_rays / dt / 1e6
    # reproducibility: every sweepable env knob that shaped this number
    # plus the resolved auto knobs
    knob_env = {k: v for k, v in os.environ.items()
                if k.startswith("VORTEX_RT_")}
    print(json.dumps({
        "metric": ("Mrays/s sustained (wavefront+packets, cornell+sphere, "
                   "512x512 spp2, 2-bounce + shadow rays, 16-frame bursts)"),
        "value": mrays,
        "unit": "Mrays/s",
        "vs_baseline": mrays / NORTH_STAR_MRAYS,
        "ms_per_frame": dt * 1e3 / (reps * burst),
        "compile_s": compile_s,
        "device": device,
        "card": card_info(),
        "knobs": dict(bvh_width=r.wa.width, max_leaf_tris=leaf,
                      fused_rows=r.wa.fused is not None,
                      bounce_packet=cfg.bounce_packet,
                      slab=cfg.slab, bounce_fronts=cfg.bounce_fronts,
                      env=knob_env),
    }))


if __name__ == "__main__":
    main()
