"""Golden renderer + scene build sanity tests."""

import numpy as np
import pytest

from vortex_rt_tpu.golden.renderer import (
    brute_force_hits, generate_rays, moller_trumbore_np, render_golden,
)
from vortex_rt_tpu.models.procedural import (
    box, checkerboard_texture, cornell_box, quad, random_soup, uv_sphere,
)
from vortex_rt_tpu.models.scene import (
    Camera, Material, RenderParams, Scene,
)
from vortex_rt_tpu.utils import vecmath as vm
from vortex_rt_tpu.utils.config import LARGE_FLOAT


def test_moller_trumbore_basic():
    v0 = np.array([[0.0, 0.0, 5.0]], np.float32)
    v1 = np.array([[2.0, 0.0, 5.0]], np.float32)
    v2 = np.array([[0.0, 2.0, 5.0]], np.float32)
    o = np.zeros((1, 3), np.float32)
    d = np.array([[0.0, 0.0, 1.0]], np.float32)
    t, w1, w2 = moller_trumbore_np(o, d, v0, v1, v2)
    assert abs(t[0] - 5.0) < 1e-5 and abs(w1[0]) < 1e-6 and abs(w2[0]) < 1e-6
    # hit at v1: shoot through (2, 0, 5) slightly inside
    d2 = np.asarray(vm.normalize(np.array([[1.98, 0.01, 5.0]], np.float32)))
    t2, w1b, _ = moller_trumbore_np(o, d2, v0, v1, v2)
    assert t2[0] < LARGE_FLOAT and w1b[0] > 0.9
    # miss
    d3 = np.array([[0.0, 0.0, -1.0]], np.float32)
    t3, _, _ = moller_trumbore_np(o, d3, v0, v1, v2)
    assert t3[0] == LARGE_FLOAT


def test_scene_build_offsets():
    sc = Scene()
    m1 = sc.add_mesh(box((0, 0, 0), 1))
    m2 = sc.add_mesh(uv_sphere((0, 0, 0), 1, 6, 8))
    sc.add_instance(m1)
    sc.add_instance(m2, vm.mat4_translate([3, 0, 0]))
    sc.add_instance(m1, vm.mat4_translate([-3, 0, 0]) @ vm.mat4_scale(0.5), 0.3)
    sb = sc.build()
    assert sb.num_instances == 3
    assert sb.num_tris == 12 + (sb.num_tris - 12)
    # BVH tri permutation is a permutation of all global ids
    assert np.array_equal(np.sort(sb.bvh_tri_idx), np.arange(sb.num_tris))
    # instance AABBs reflect transforms
    assert sb.inst_aabb_min[1][0] > 1.0
    assert sb.inst_aabb_max[2][0] < 0.0
    # TLAS leaves cover all instances
    assert np.array_equal(np.sort(sb.tlas_inst_idx), np.arange(3))
    # scene aabb sane
    lo, hi = sb.scene_aabb()
    assert (lo < hi).all()


def test_brute_force_hits_sphere_silhouette():
    sc = Scene()
    sc.add_mesh(uv_sphere((0, 0, 0), 1.0, 16, 24))
    sb = sc.build()
    cam = Camera.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0], 40.0, 1.0)
    o, d = generate_rays(cam, 33, 33)
    hits = brute_force_hits(o, d, sb)
    img = (hits["dist"] < LARGE_FLOAT).reshape(33, 33)
    # center pixel hits, corners miss
    assert img[16, 16]
    assert not img[0, 0] and not img[0, -1] and not img[-1, 0]
    # hit distance near 3 (sphere radius 1, camera at 4)
    assert abs(hits["dist"].reshape(33, 33)[16, 16] - 3.0) < 0.05
    # silhouette roughly circular: hit count close to pi*r^2 in pixels
    frac = img.mean()
    assert 0.1 < frac < 0.6


def test_instance_transform_hits():
    """A translated instance must be hit where its world AABB is."""
    sc = Scene()
    mi = sc.add_mesh(box((0, 0, 0), 0.5))
    sc.add_instance(mi, vm.mat4_translate([5, 0, 0]))
    sb = sc.build()
    o = np.array([[5.0, 0.0, -4.0], [0.0, 0.0, -4.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)
    hits = brute_force_hits(o, d, sb)
    assert hits["dist"][0] < LARGE_FLOAT and abs(hits["dist"][0] - 3.5) < 1e-3
    assert hits["dist"][1] == LARGE_FLOAT


def test_render_golden_cornell():
    sc = Scene()
    for mesh, refl in cornell_box():
        i = sc.add_mesh(mesh)
        sc.add_instance(i, reflectivity=refl)
    sb = sc.build()
    cam = Camera.look_at([0, 0, -3.2], [0, 0, 0], [0, 1, 0], 45.0, 1.0)
    params = RenderParams(light_pos=(0, 0.8, -0.5), max_depth=2)
    img = render_golden(sb, cam, params, 48, 48)
    assert img.shape == (48, 48, 3)
    assert np.isfinite(img).all()
    # left wall (low x in pixels: x_ndc<0 maps along -right...) — just check
    # that red and green dominate on opposite sides of the image
    left = img[:, :10].mean(axis=(0, 1))
    right = img[:, -10:].mean(axis=(0, 1))
    red_side = left if left[0] > right[0] else right
    green_side = right if left[0] > right[0] else left
    assert red_side[0] > red_side[1]   # red wall: R > G
    assert green_side[1] > green_side[0]  # green wall: G > R
    # something was actually lit
    assert img.max() > 0.05


def test_render_golden_reflection_bounces():
    """With max_depth=1 vs 3, the reflective sphere must change appearance."""
    sc = Scene()
    for mesh, refl in cornell_box():
        i = sc.add_mesh(mesh)
        sc.add_instance(i, reflectivity=refl)
    sb = sc.build()
    cam = Camera.look_at([0, 0, -3.2], [0, 0, 0], [0, 1, 0], 45.0, 1.0)
    p1 = RenderParams(light_pos=(0, 0.8, -0.5), max_depth=1)
    p3 = RenderParams(light_pos=(0, 0.8, -0.5), max_depth=3)
    i1 = render_golden(sb, cam, p1, 32, 32)
    i3 = render_golden(sb, cam, p3, 32, 32)
    assert np.abs(i1 - i3).max() > 1e-3


def test_textured_quad():
    tex = checkerboard_texture(4, 0xFF0000, 0x0000FF, cell=2)
    m = Material(diffuse_tex=tex)
    sc = Scene()
    sc.add_mesh(quad((-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0), m))
    sb = sc.build()
    assert sb.mat_tex_offset[0] == 0 and sb.mat_tex_w[0] == 8
    cam = Camera.look_at([0, 0, -3], [0, 0, 0], [0, 1, 0], 45.0, 1.0)
    params = RenderParams(light_pos=(0, 0, -5), ambient_color=(1, 1, 1),
                          light_color=(0, 0, 0), max_depth=1,
                          background_color=(0, 0, 0))
    img = render_golden(sb, cam, params, 64, 64)
    center = img[24:40, 24:40]
    # both checker colors appear
    assert (center[..., 0] > 0.5).any()
    assert (center[..., 2] > 0.5).any()


def test_arrange_around_y():
    from vortex_rt_tpu.models.procedural import box

    sc = Scene()
    for _ in range(4):
        i = sc.add_mesh(box((0, 0, 0), 1.0))
        sc.add_instance(i)
    sc.arrange_around_y(margin=0.1)
    sb = sc.build()
    centers = (sb.inst_aabb_min + sb.inst_aabb_max) / 2
    # all on a circle around Y: equal radii, distinct angles
    r = np.hypot(centers[:, 0], centers[:, 2])
    assert np.allclose(r, r[0], rtol=1e-5) and r[0] > 1.0
    # pairwise separation: no overlapping footprints
    for i in range(4):
        for j in range(i + 1, 4):
            d = np.hypot(*(centers[i, [0, 2]] - centers[j, [0, 2]]))
            assert d > 1.9  # 2 * half-extent(1.0) with margin


@pytest.mark.parametrize("spp,shadow", [(1, True), (2, False), (4, True)])
def test_sample_pixel_parity_replays_device_jitter(spp, shadow):
    """The sampled-pixel oracle replays the device frame's stratified
    camera jitter at any spp (Whitted integrator), so a device frame
    agrees with it pixel for pixel."""
    from vortex_rt_tpu.engine.wavefront import WavefrontRenderer
    from vortex_rt_tpu.golden.renderer import sample_pixel_parity
    from vortex_rt_tpu.models.procedural import cornell_box
    from vortex_rt_tpu.models.scene import RenderParams, Scene
    from vortex_rt_tpu.utils.config import RTConfig

    sc = Scene()
    for mesh, refl in cornell_box():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    cfg = RTConfig(flatten=True)
    sb = sc.build(cfg)
    cam = Scene.framing_camera(sb, 45.0, 1.0)
    p = RenderParams(max_depth=2, spp=spp, shadow=shadow,
                     light_pos=(0, 0.8, -0.5))
    img, _ = WavefrontRenderer.from_buffers(sb, cfg).render(cam, p, 16, 16)
    rmse, _, _ = sample_pixel_parity(sb, cam, p, 16, 16, img, n=48, seed=3)
    assert rmse < 3e-3
