"""Scale-ladder scenes (BASELINE configs 3-4 stand-ins) on the CPU backend.

The reference's own default scene is Sponza at 640x480
(tests/regression/raytracing/main.cpp:20-27); its fidelity strategy is a
host render of the identical code compared by image (raycast
tracer.cpp:226-263).  Full-frame brute-force parity is O(R*T) and
unusable at these triangle counts, so these tests use the sampled-pixel
oracle (golden.renderer.sample_pixel_parity) at reduced resolution; the
1080p runs on the card are chip_smoke.py and tools/bench_ladder.py.
"""

import numpy as np
import pytest

from vortex_rt_tpu.engine.wavefront import WavefrontRenderer
from vortex_rt_tpu.golden.renderer import sample_pixel_parity
from vortex_rt_tpu.models import bigscenes
from vortex_rt_tpu.models.scene import RenderParams, Scene


def _build(meshes):
    sc = Scene()
    for m, refl in meshes:
        sc.add_instance(sc.add_mesh(m), reflectivity=refl)
    return sc.build()


@pytest.mark.parametrize("name", ["blob", "atrium"])
def test_scale_scene_parity(name):
    if name == "blob":
        # reduced-res blob keeps CPU runtime sane but keeps the organic
        # displaced geometry (config-3 character)
        sb = _build([(bigscenes.blob(n=96), 0.0)])
    else:
        sb = _build(bigscenes.atrium(n_cols=6, target_tris=60_000))
    w = h = 96
    cam = Scene.framing_camera(sb, 45.0, 1.0, zoom=1.0)
    params = RenderParams(max_depth=2, shadow=True)
    r = WavefrontRenderer.from_buffers(sb)
    img, nrays = r.render(cam, params, w, h)
    assert nrays >= w * h
    rmse, worst, where = sample_pixel_parity(
        sb, cam, params, w, h, img, n=48, seed=3)
    # the sampled oracle is exact per pixel; allow a seam-tie pixel or two
    assert rmse < 3e-3, (rmse, worst, where)


def test_wavy_grid_geometry():
    m = bigscenes.wavy_grid(n=64, t=0.5)
    assert m.num_tris == 2 * 63 * 63
    # animated: a different t moves vertices (y only)
    m2 = bigscenes.wavy_grid(n=64, t=1.5)
    assert not np.allclose(m.v0, m2.v0)
    assert np.allclose(m.v0[:, [0, 2]], m2.v0[:, [0, 2]])


def test_triangle_budgets():
    assert abs(bigscenes.blob(n=187).num_tris - 69_000) < 2_000
    total = sum(m.num_tris for m, _ in bigscenes.atrium())
    assert abs(total - 260_000) < 10_000
