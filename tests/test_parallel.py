"""Multi-chip tile sharding on the virtual 8-device CPU mesh."""

import jax
import numpy as np
from jax.sharding import Mesh

from vortex_rt_tpu.engine.megakernel import MegakernelRenderer
from vortex_rt_tpu.models.procedural import cornell_box
from vortex_rt_tpu.models.scene import Camera, RenderParams, Scene
from vortex_rt_tpu.parallel.tiles import render_tiled


def _scene():
    sc = Scene()
    for mesh, refl in cornell_box():
        i = sc.add_mesh(mesh)
        sc.add_instance(i, reflectivity=refl)
    return sc.build()


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_tiled_matches_single_device():
    sb = _scene()
    cam = Camera.look_at([0.11, 0.07, -3.2], [0.02, -0.01, 0], [0, 1, 0],
                         45.0, 1.0)
    params = RenderParams(light_pos=(0, 0.8, -0.5), max_depth=2)
    w = h = 32
    img_tiled, total = render_tiled(sb, cam, params, w, h)
    r = MegakernelRenderer.from_buffers(sb)
    img_single, nrays = r.render(cam, params, w, h)
    assert total == nrays
    # same math modulo compilation fusion: allow seam-tie pixels only
    bad = np.abs(img_tiled - img_single).max(-1) > 1e-4
    assert bad.mean() < 0.01


def test_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert np.isfinite(np.asarray(out)).all()


def test_tiled_wavefront_matches_single():
    from vortex_rt_tpu.engine.wavefront import WavefrontRenderer
    from vortex_rt_tpu.parallel.tiles import render_tiled_wavefront
    from vortex_rt_tpu.utils.config import RTConfig

    sb = _scene()
    cam = Camera.look_at([0.11, 0.07, -3.2], [0.02, -0.01, 0], [0, 1, 0],
                         45.0, 1.0)
    params = RenderParams(light_pos=(0, 0.8, -0.5), max_depth=2)
    w, h = 16, 16
    img_tiled, total = render_tiled_wavefront(sb, cam, params, w, h,
                                              chunk=32)
    r = WavefrontRenderer.from_buffers(sb, RTConfig(lanes=32))
    img_single, nrays = r.render(cam, params, w, h, mode="fused")
    assert total == nrays
    bad = np.abs(img_tiled - img_single).max(-1) > 1e-4
    assert bad.mean() < 0.02


def test_dryrun_needs_devices_and_never_switches_platform():
    """dryrun runs on the devices the process has: asking for more than
    the 8 virtual CPU devices raises instead of re-initialising JAX."""
    import pytest

    from vortex_rt_tpu.parallel.tiles import dryrun

    before = (jax.default_backend(), len(jax.devices()))
    with pytest.raises(ValueError):
        dryrun(16)
    assert (jax.default_backend(), len(jax.devices())) == before
