"""Wavefront engine: image parity + shader table programmability."""

import jax.numpy as jnp
import numpy as np
import pytest

from vortex_rt_tpu.engine.megakernel import (
    CameraArrays, MegakernelRenderer, generate_camera_rays,
)
from vortex_rt_tpu.engine.shaders import ShaderTable
from vortex_rt_tpu.engine.wavefront import WavefrontRenderer
from vortex_rt_tpu.golden.renderer import render_golden
from vortex_rt_tpu.models.procedural import cornell_box, quad
from vortex_rt_tpu.models.scene import Camera, Material, RenderParams, Scene
from vortex_rt_tpu.utils.config import (
    COMMIT_ACCEPT, COMMIT_CONT, COMMIT_TERM, RTConfig,
)
from vortex_rt_tpu.utils.image import rmse


def _cornell_scene():
    sc = Scene()
    for mesh, refl in cornell_box():
        i = sc.add_mesh(mesh)
        sc.add_instance(i, reflectivity=refl)
    return sc


def _device_rays(cam, w, h):
    o, d = generate_camera_rays(CameraArrays.from_camera(cam), w, h)
    return np.asarray(o), np.asarray(d)


CFG = RTConfig(lanes=512)  # small chunks so tests exercise multi-chunk paths


def test_wavefront_matches_golden():
    sc = _cornell_scene()
    sb = sc.build()
    r = WavefrontRenderer.from_buffers(sb, CFG)
    cam = Camera.look_at([0.11, 0.07, -3.2], [0.02, -0.01, 0], [0, 1, 0],
                         45.0, 1.0)
    params = RenderParams(light_pos=(0, 0.8, -0.5), max_depth=3)
    img, nrays = r.render(cam, params, 40, 40)
    gold = render_golden(sb, cam, params, 40, 40, rays=_device_rays(cam, 40, 40))
    assert nrays > 40 * 40  # secondary rays happened
    assert rmse(np.clip(img, 0, 1), np.clip(gold, 0, 1)) <= 1e-3


def test_wavefront_matches_megakernel_spp():
    sc = _cornell_scene()
    sb = sc.build()
    wf = WavefrontRenderer.from_buffers(sb, CFG)
    cam = Camera.look_at([0.11, 0.07, -3.2], [0.02, -0.01, 0], [0, 1, 0],
                         45.0, 1.0)
    params = RenderParams(light_pos=(0, 0.8, -0.5), max_depth=2, spp=2)
    img, nrays = wf.render(cam, params, 24, 24)
    assert np.isfinite(img).all()
    assert nrays >= 24 * 24 * 2
    # sample 0 is pixel-centered, so spp result stays near spp=1 result
    p1 = RenderParams(light_pos=(0, 0.8, -0.5), max_depth=2, spp=1)
    i1, _ = wf.render(cam, p1, 24, 24)
    assert np.abs(img - i1).mean() < 0.2


def test_wavefront_custom_miss_shader():
    """SBT programmability: a custom miss shader changes the background."""

    def pink_miss(ctx, ray, payload):
        ones = jnp.ones_like(ray.dx)
        return ones * 1.0, ones * 0.0, ones * 1.0

    sc = Scene()
    sc.add_mesh(quad((-0.5, -0.5, 2), (0.5, -0.5, 2), (0.5, 0.5, 2),
                     (-0.5, 0.5, 2)))
    sb = sc.build()
    r = WavefrontRenderer.from_buffers(
        sb, CFG, table=ShaderTable(miss=pink_miss))
    cam = Camera.look_at([0, 0, -2], [0, 0, 0], [0, 1, 0], 40.0, 1.0)
    img, _ = r.render(cam, RenderParams(max_depth=1), 16, 16)
    corner = img[0, 0]
    np.testing.assert_allclose(corner, [1.0, 0.0, 1.0], atol=1e-6)


def test_wavefront_anyhit_reject_instance():
    """Any-hit suspension through the engine: CONT-reject the near quad."""

    def reject_inst0(ctx, sp, ray, payload):
        return jnp.where(sp.inst == 0, jnp.int32(COMMIT_CONT),
                         jnp.int32(COMMIT_ACCEPT))

    sc = Scene()
    near = sc.add_mesh(quad((-2, -2, 1), (2, -2, 1), (2, 2, 1), (-2, 2, 1),
                            Material(diffuse=(1.0, 1.0, 1.0))))
    far = sc.add_mesh(quad((-2, -2, 3), (2, -2, 3), (2, 2, 3), (-2, 2, 3),
                           Material(diffuse=(1.0, 0.0, 0.0))))
    sc.add_instance(near)
    sc.add_instance(far)
    sb = sc.build()
    cam = Camera.look_at([0, 0.1, -1], [0, 0.1, 1], [0, 1, 0], 30.0, 1.0)

    r_plain = WavefrontRenderer.from_buffers(sb, CFG)
    r_rej = WavefrontRenderer.from_buffers(
        sb, CFG, table=ShaderTable(anyhit=reject_inst0))
    params = RenderParams(max_depth=1, light_pos=(0, 0, -5))
    i_plain, _ = r_plain.render(cam, params, 16, 16)
    i_rej, _ = r_rej.render(cam, params, 16, 16)
    # plain sees the white near quad; rejecting inst 0 exposes the red one
    assert i_plain[8, 8, 1] > 0.1          # white has green component
    assert i_rej[8, 8, 1] < 1e-3           # red quad: no green
    assert i_rej[8, 8, 0] > 0.1


def test_wavefront_anyhit_term_gives_miss_color():
    def term_all(ctx, sp, ray, payload):
        return jnp.full_like(sp.inst, COMMIT_TERM)

    sc = Scene()
    sc.add_mesh(quad((-2, -2, 1), (2, -2, 1), (2, 2, 1), (-2, 2, 1)))
    sb = sc.build()
    r = WavefrontRenderer.from_buffers(
        sb, CFG, table=ShaderTable(anyhit=term_all))
    cam = Camera.look_at([0, 0.1, -1], [0, 0.1, 1], [0, 1, 0], 30.0, 1.0)
    params = RenderParams(max_depth=1, background_color=(0.1, 0.2, 0.3))
    img, _ = r.render(cam, params, 8, 8)
    # TERM leaves dist at miss -> the engine shades it with the miss shader
    np.testing.assert_allclose(img[4, 4], [0.1, 0.2, 0.3], atol=1e-6)


def test_wavefront_nonmultiple_pool():
    """Pixel counts that don't divide the chunk size get padded lanes."""
    sc = _cornell_scene()
    r = WavefrontRenderer.from_scene(sc, RTConfig(lanes=4096))
    cam = Camera.look_at([0.11, 0.07, -3.2], [0.02, -0.01, 0], [0, 1, 0],
                         45.0, 1.0)
    img, _ = r.render(cam, RenderParams(max_depth=2), 30, 30)  # 900 rays
    assert img.shape == (30, 30, 3)
    assert np.isfinite(img).all()


def test_chunked_mode_matches_fused():
    """The host-orchestrated chunked path must agree with the fused one-jit
    path (only compilation structure differs)."""
    sc = _cornell_scene()
    sb = sc.build()
    # packet_size=0 so both modes use the per-ray engine (the comparison
    # gates orchestration equivalence, not cross-engine ULP seam noise)
    r = WavefrontRenderer.from_buffers(
        sb, RTConfig(lanes=512, packet_size=0))
    cam = Camera.look_at([0.11, 0.07, -3.2], [0.02, -0.01, 0], [0, 1, 0],
                         45.0, 1.0)
    params = RenderParams(light_pos=(0, 0.8, -0.5), max_depth=3)
    i_fused, n_fused = r.render(cam, params, 24, 24, mode="fused")
    i_chunk, n_chunk = r.render(cam, params, 24, 24, mode="chunked")
    assert n_fused == n_chunk
    bad = np.abs(i_fused - i_chunk).max(-1) > 1e-4
    assert bad.mean() < 0.01  # only seam-tie pixels may differ


def test_shadow_rays_match_golden():
    """BASELINE config-2 ladder: occlusion-tested direct lighting."""
    from vortex_rt_tpu.models.procedural import quad

    sc = Scene()
    # floor (upward normal) + an occluder between the light and the floor
    sc.add_mesh(quad((-2, 0, -2), (-2, 0, 2), (2, 0, 2), (2, 0, -2)))
    sc.add_mesh(quad((-0.5, 1.0, -0.5), (0.5, 1.0, -0.5),
                     (0.5, 1.0, 0.5), (-0.5, 1.0, 0.5)))
    sb = sc.build()
    r = WavefrontRenderer.from_buffers(sb, CFG)
    cam = Camera.look_at([0.3, 2.5, -3.0], [0, 0, 0], [0, 1, 0], 50.0, 1.0)
    params_on = RenderParams(light_pos=(0, 3, 0), max_depth=1, shadow=True)
    params_off = RenderParams(light_pos=(0, 3, 0), max_depth=1, shadow=False)

    img_on, nrays_on = r.render(cam, params_on, 32, 32)
    img_off, nrays_off = r.render(cam, params_off, 32, 32)
    assert nrays_on > nrays_off  # shadow rays were traced
    # a shadowed region exists and is darker than without shadows
    assert (img_on <= img_off + 1e-6).all()
    assert (img_off - img_on).max() > 0.05

    from vortex_rt_tpu.golden.renderer import render_golden

    gold = render_golden(sb, cam, params_on, 32, 32,
                         rays=_device_rays(cam, 32, 32))
    bad = np.abs(img_on - gold).max(-1) > 1e-4
    assert bad.mean() < 0.02


def test_render_burst_scalar_api():
    """Burst program is scalar-only (compile-basin rule 13): ray counts
    must equal n_frames x the single-frame count, and the image variant
    must return the separate single-frame render."""
    sb = _cornell_scene().build()
    cam = Scene.framing_camera(sb, 45.0, 1.0)
    r = WavefrontRenderer.from_buffers(sb)
    p = RenderParams(max_depth=2)
    img1, n1 = r.render(cam, p, 32, 32)
    n4 = r.render_burst(cam, p, 32, 32, n_frames=4, rays_only=True)
    assert n4 == 4 * n1  # spp=1: every frame traces the same waves
    img, nb = r.render_burst(cam, p, 32, 32, n_frames=4)
    assert nb == n4
    np.testing.assert_allclose(img, img1, atol=1e-6)


def test_bilinear_texture_parity():
    """Bilinear sampling (texSampleBi, raycast/render.h:24-56) matches the
    golden filter and actually differs from point sampling."""
    from vortex_rt_tpu.golden.renderer import render_golden
    from vortex_rt_tpu.models.procedural import checkerboard_texture

    tex = checkerboard_texture(n=4, cell=3)  # coarse: filters diverge
    sc = Scene()
    m = quad((-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0),
             Material(diffuse=(1, 1, 1), diffuse_tex=tex))
    sc.add_instance(sc.add_mesh(m))
    sb = sc.build()
    cam = Camera.look_at([0.2, 0.1, -2.6], [0, 0, 0], [0, 1, 0], 45.0, 1.0)
    p = RenderParams(max_depth=1)
    w = h = 64

    r_pt = WavefrontRenderer.from_buffers(sb, RTConfig())
    r_bi = WavefrontRenderer.from_buffers(sb, RTConfig(tex_filter="bilinear"))
    img_pt, _ = r_pt.render(cam, p, w, h)
    img_bi, _ = r_bi.render(cam, p, w, h)
    assert float(np.abs(img_bi - img_pt).mean()) > 1e-3  # filter matters

    ref_bi = render_golden(sb, cam, p, w, h, bilinear=True)
    assert rmse(img_bi, ref_bi) < 3e-3


def test_alpha_cutout_anyhit():
    """Texture-driven alpha cutout via the suspension protocol: rays
    through dark checker cells of a front quad must pass through and hit
    the back quad; rays through bright cells stop at the front."""
    from vortex_rt_tpu.engine.shaders import alpha_test_anyhit
    from vortex_rt_tpu.models.procedural import checkerboard_texture

    # front quad: black/white checker; back quad: solid red, behind it
    tex = checkerboard_texture(n=2, c0=0xFFFFFF, c1=0x000000, cell=2)
    sc = Scene()
    front = quad((-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0),
                 Material(diffuse=(1, 1, 1), diffuse_tex=tex))
    back = quad((-2, -2, 1.5), (2, -2, 1.5), (2, 2, 1.5), (-2, 2, 1.5),
                Material(diffuse=(0.9, 0.05, 0.05)))
    sc.add_instance(sc.add_mesh(front))
    sc.add_instance(sc.add_mesh(back))
    sb = sc.build()
    cam = Camera.look_at([0.0, 0.0, -2.5], [0, 0, 0], [0, 1, 0], 45.0, 1.0)
    p = RenderParams(max_depth=1)
    w = h = 64

    r_cut = WavefrontRenderer.from_buffers(
        sb, CFG, table=ShaderTable(anyhit=alpha_test_anyhit(0.1)))
    img_cut, _ = r_cut.render(cam, p, w, h)
    r_solid = WavefrontRenderer.from_buffers(sb, CFG)
    img_solid, _ = r_solid.render(cam, p, w, h)

    # dark checker cells (luminance 0 < 0.1) are cut out: those rays see
    # the red back quad (luminance 0.23 >= 0.1, accepted); in the solid
    # render they shade the black front cell instead
    redness = img_cut[:, :, 0] - img_cut[:, :, 1]
    # the image must contain clearly red pixels (seen-through regions;
    # ambient-only shading of the 0.9-red back quad gives ~0.18 red)
    assert (redness > 0.1).sum() > 50
    # and the solid render must not (crop the border: the larger back
    # quad is legitimately visible around the front quad's edges)
    core = img_solid[4:60, 4:60]
    assert ((core[:, :, 0] - core[:, :, 1]) > 0.1).sum() == 0


def test_merged_shadow_bounce_wave_bitwise():
    """The merged shadow+next-bounce wave (one occl_split packet loop +
    lit=0/1 shader blend) computes the same arithmetic as the
    sequential shadow -> shade -> bounce pipeline
    (lit_independent_spawn=False forces the fallback); the compiled
    programs differ only by XLA fusion/FMA reassociation (<= ~2 ulp on
    ~1% of pixels).  Ray counts are exactly equal (same kill/spawn
    decisions)."""
    import dataclasses

    from vortex_rt_tpu.engine.shaders import ShaderTable, pathtrace_closest
    from vortex_rt_tpu.engine.wavefront import WavefrontRenderer
    from vortex_rt_tpu.models.procedural import cornell_box, uv_sphere
    from vortex_rt_tpu.models.scene import Camera, RenderParams, Scene

    sc = Scene()
    for mesh, refl in cornell_box():
        sc.add_instance(sc.add_mesh(mesh), reflectivity=refl)
    sc.add_instance(sc.add_mesh(uv_sphere((0, -0.3, 0), 0.35, 10, 20)))
    sb = sc.build()
    cam = Camera.look_at([0.05, 0.02, -3.2], [0, -0.05, 0], [0, 1, 0],
                         45.0, 1.0)
    p = RenderParams(light_pos=(0, 0.8, -0.5), max_depth=3, spp=2,
                     shadow=True, pathtrace=True)
    r = WavefrontRenderer.from_buffers(sb)
    img_m, rays_m = r.render(cam, p, 64, 64)
    seq_table = dataclasses.replace(r._table_for(p),
                                    lit_independent_spawn=False)
    r._tables = {}  # drop the cached table
    orig = WavefrontRenderer._table_for
    try:
        WavefrontRenderer._table_for = lambda self, params: seq_table
        img_s, rays_s = r.render(cam, p, 64, 64)
    finally:
        WavefrontRenderer._table_for = orig
    np.testing.assert_allclose(np.asarray(img_m), np.asarray(img_s),
                               atol=5e-7, rtol=5e-7)
    assert int(rays_m) == int(rays_s)


def test_render_burst_rays_equal_sum_of_frames():
    """One burst program traces exactly the rays of the same frames
    rendered one by one (seeds seed0..seed0+n-1); spp 2 makes every
    frame's jitter, and so its bounce rays, seed-dependent."""
    from vortex_rt_tpu.engine.megakernel import CameraArrays, LightArrays
    from vortex_rt_tpu.engine.wavefront import render_burst, render_frame

    sb = _cornell_scene().build(RTConfig(flatten=True))
    cam = Scene.framing_camera(sb, 45.0, 1.0)
    r = WavefrontRenderer.from_buffers(sb, RTConfig(flatten=True))
    p = RenderParams(max_depth=2, spp=2, shadow=True, pathtrace=True)
    table = r._table_for(p)
    ca, light = CameraArrays.from_camera(cam), LightArrays.from_params(p)
    kw = dict(max_depth=2, spp=2, table=table, shadow=True,
              packet=r.config.packet_size,
              bounce_packet=r.config.bounce_packet,
              bounce_fronts=r.config.bounce_fronts, slab=r.config.slab)
    seed0, n = 5, 3
    per_frame = [int(render_frame(r.wa, r.sa, ca, light, 16, 16, seed=s,
                                  **kw)[1])
                 for s in range(seed0, seed0 + n)]
    burst = int(render_burst(r.wa, r.sa, ca, light, 16, 16, n_frames=n,
                             seed0=seed0, **kw))
    assert burst == sum(per_frame)
    assert len(set(per_frame)) > 1 or per_frame[0] > 16 * 16 * 2


@pytest.mark.parametrize("shadow", [False, True])
def test_alpha_cutout_matches_golden_oracle(shadow):
    """The golden oracle's alpha predicate (golden.alpha_keep) reproduces
    the device's in-loop alpha any-hit frame, shadow rays included."""
    from vortex_rt_tpu.engine.shaders import alpha_test_anyhit
    from vortex_rt_tpu.golden.renderer import alpha_keep
    from vortex_rt_tpu.models.procedural import checkerboard_texture

    tex = checkerboard_texture(n=2, c0=0xFFFFFF, c1=0x000000, cell=2)
    sc = Scene()
    front = quad((-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0),
                 Material(diffuse=(1, 1, 1), diffuse_tex=tex))
    back = quad((-2, -2, 1.5), (2, -2, 1.5), (2, 2, 1.5), (-2, 2, 1.5),
                Material(diffuse=(0.9, 0.05, 0.05)))
    sc.add_instance(sc.add_mesh(front))
    sc.add_instance(sc.add_mesh(back))
    cfg = RTConfig(flatten=True)
    sb = sc.build(cfg)
    cam = Camera.look_at([0.0, 0.0, -2.5], [0, 0, 0], [0, 1, 0], 45.0, 1.0)
    p = RenderParams(max_depth=2, shadow=shadow, light_pos=(0, 0, -3))
    w = h = 32
    r = WavefrontRenderer.from_buffers(
        sb, cfg, table=ShaderTable(anyhit=alpha_test_anyhit(0.1)))
    img, _ = r.render(cam, p, w, h)
    gold = render_golden(sb, cam, p, w, h, rays=_device_rays(cam, w, h),
                         keep=alpha_keep(sb, 0.1))
    solid = render_golden(sb, cam, p, w, h, rays=_device_rays(cam, w, h))
    assert rmse(img, gold) < 3e-3
    assert rmse(gold, solid) > 1e-2  # the cutout changes the image
