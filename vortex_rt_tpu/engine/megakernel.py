"""Megakernel renderer: one fused jit for the whole frame.

This is the "minimum end-to-end device slice" (SURVEY.md section 7 phase 3) and
the functional analog of the raycast app's software render loop
(tests/regression/raycast/render.h Trace + kernel main): generate camera
rays, trace, shade, bounce, accumulate — but as ONE XLA program over the
entire SoA ray batch instead of per-thread scalar code.  The wavefront
engine (engine.wavefront) supersedes this for shader-queue parity; the
megakernel remains the simplest correct device renderer and the baseline
for benchmarking regroup strategies against.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vortex_rt_tpu.models.scene import (
    Camera, RenderParams, Scene, SceneBuffers,
)
from vortex_rt_tpu.ops.shade import closest_hit_shade
from vortex_rt_tpu.ops.traverse2 import TraversalArrays, trace_rays
from vortex_rt_tpu.utils.config import LARGE_FLOAT, RTConfig


class CameraArrays(NamedTuple):
    """Camera as a device pytree (kernel_arg_t camera block)."""

    pos: jnp.ndarray
    forward: jnp.ndarray
    right: jnp.ndarray
    up: jnp.ndarray
    viewplane: jnp.ndarray

    @staticmethod
    def from_camera(cam: Camera) -> "CameraArrays":
        return CameraArrays(*(jnp.asarray(a) for a in cam.as_arrays()))


class LightArrays(NamedTuple):
    """Lighting/integrator constants (kernel_arg_t lighting block)."""

    light_pos: jnp.ndarray
    light_color: jnp.ndarray
    ambient: jnp.ndarray
    background: jnp.ndarray

    @staticmethod
    def from_params(p: RenderParams) -> "LightArrays":
        f = lambda x: jnp.asarray(x, jnp.float32)
        return LightArrays(f(p.light_pos), f(p.light_color),
                           f(p.ambient_color), f(p.background_color))


def generate_camera_rays(cam: CameraArrays, width: int, height: int,
                         jitter: Optional[jnp.ndarray] = None):
    """Primary rays, (H*W, 3) each — GenerateRay (render.h:190-208).

    ``jitter``: optional (H, W, 2) in [0,1) for stratified spp (defaults to
    the reference's pixel-center 0.5)."""
    x = jnp.arange(width, dtype=jnp.float32)
    y = jnp.arange(height, dtype=jnp.float32)
    xx, yy = jnp.meshgrid(x, y)
    if jitter is None:
        jx = jy = 0.5
    else:
        jx, jy = jitter[..., 0], jitter[..., 1]
    x_ndc = (xx + jx) / width - 0.5
    y_ndc = (yy + jy) / height - 0.5
    pt = ((x_ndc * cam.viewplane[0])[..., None] * cam.right
          + (y_ndc * cam.viewplane[1])[..., None] * cam.up
          + cam.forward)
    d = pt / jnp.sqrt((pt * pt).sum(-1, keepdims=True))
    o = jnp.broadcast_to(cam.pos, d.shape)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def trace_wave(ta: TraversalArrays, sb: SceneBuffers, light: LightArrays,
               o, d, radiance, throughput, active, bounce: int,
               max_depth: int):
    """One bounce of the Trace() loop over the whole batch (render.h:210-276).

    Returns updated (o, d, radiance, throughput, active) plus perf counters.
    """
    hits, perf = trace_rays(ta, o, d)
    hit = hits.dist < LARGE_FLOAT

    shade = closest_hit_shade(
        sb, o, d, jnp.minimum(hits.dist, 1e18), hits.bx, hits.by, hits.bz,
        hits.tri, hits.inst,
        light.ambient, light.light_color, light.light_pos,
    )

    miss_now = active & ~hit
    radiance = radiance + jnp.where(
        miss_now[:, None], throughput[:, None] * light.background, 0.0)

    h = active & hit
    radiance = radiance + jnp.where(
        h[:, None],
        (throughput * (1.0 - shade.reflectivity))[:, None] * shade.diffuse,
        0.0)
    throughput = jnp.where(h, throughput * shade.reflectivity, throughput)

    bounce_more = h & (shade.reflectivity > 0.0) & (bounce + 1 < max_depth)
    stop = h & ~bounce_more
    radiance = radiance + jnp.where(
        stop[:, None], throughput[:, None] * light.background, 0.0)

    o = jnp.where(bounce_more[:, None], shade.new_o, o)
    d = jnp.where(bounce_more[:, None], shade.new_d, d)
    return o, d, radiance, throughput, bounce_more, perf


@partial(jax.jit, static_argnames=("width", "height", "max_depth", "spp"))
def render_megakernel(ta: TraversalArrays, sb: SceneBuffers,
                      cam: CameraArrays, light: LightArrays,
                      width: int, height: int, max_depth: int = 2,
                      spp: int = 1, seed: int = 0):
    """Full frame -> ((H, W, 3) radiance, total rays traced)."""
    acc = jnp.zeros((width * height, 3), jnp.float32)
    rays_traced = jnp.int32(0)
    key = jax.random.PRNGKey(seed)
    for s in range(spp):
        if spp == 1:
            jitter = None
        else:
            key, k2 = jax.random.split(key)
            jitter = jax.random.uniform(k2, (height, width, 2))
        o, d = generate_camera_rays(cam, width, height, jitter)
        radiance = jnp.zeros((width * height, 3), jnp.float32)
        throughput = jnp.ones(width * height, jnp.float32)
        active = jnp.ones(width * height, bool)
        for bounce in range(max_depth):
            rays_traced = rays_traced + active.sum(dtype=jnp.int32)
            o, d, radiance, throughput, active, _ = trace_wave(
                ta, sb, light, o, d, radiance, throughput, active,
                bounce, max_depth)
        acc = acc + radiance
    img = (acc / spp).reshape(height, width, 3)
    return img, rays_traced


@dataclasses.dataclass
class MegakernelRenderer:
    """Host-facing renderer: owns the device scene, mirrors Tracer
    (tests/regression/raytracing/tracer.{h,cpp}) minus the driver plumbing
    (which lives in runtime.device)."""

    sb: SceneBuffers          # device pytree
    ta: TraversalArrays
    config: RTConfig

    @staticmethod
    def from_scene(scene: Scene, config: Optional[RTConfig] = None
                   ) -> "MegakernelRenderer":
        cfg = config or RTConfig()
        sb_host = scene.build(cfg)
        return MegakernelRenderer.from_buffers(sb_host, cfg)

    @staticmethod
    def from_buffers(sb_host: SceneBuffers, config: Optional[RTConfig] = None
                     ) -> "MegakernelRenderer":
        cfg = config or RTConfig()
        ta = TraversalArrays.from_scene(sb_host)
        sb = jax.tree.map(jnp.asarray, sb_host)
        return MegakernelRenderer(sb=sb, ta=ta, config=cfg)

    def render(self, cam: Camera, params: RenderParams,
               width: Optional[int] = None, height: Optional[int] = None
               ) -> Tuple[np.ndarray, int]:
        w = width or self.config.width
        h = height or self.config.height
        img, nrays = render_megakernel(
            self.ta, self.sb, CameraArrays.from_camera(cam),
            LightArrays.from_params(params),
            w, h, max_depth=params.max_depth, spp=params.spp,
        )
        return np.asarray(img), int(nrays)
