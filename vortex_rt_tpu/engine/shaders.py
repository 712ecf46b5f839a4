"""Shader binding table (SBT) analog: programmable batch shaders.

The reference dispatches per-ray shaders through a table of function
pointers uploaded as flat binaries (tracer.cpp:118-121 uploads miss/
closest/anyhit to fixed VMAs; kernel.cpp:86-91 dispatches
``sbt[type](rayID, arg)``).  The JAX equivalent is a table of
JAX-traceable *batch* functions: each shader runs over the whole regrouped
lane batch of its type at once — the dense-warp execution the reference's
ShaderQueue regrouping works so hard to approximate, obtained for free.

Shader signatures (all inputs/outputs are (R,) lanes):

closest(ctx, sp, ray, payload) -> ClosestOut
    ctx: ShaderContext (scene tables + lighting constants)
    sp:  ops.shade_lanes.ShadePoint (every getAttr the reference exposes)
    ray: RayLanes (origin/direction)
    payload: PayloadLanes (throughput, bounce, pixel)
miss(ctx, ray, payload) -> (add_r, add_g, add_b)   [terminates the ray]
anyhit(ctx, sp, ray, payload) -> (R,) i32 commit action
    (COMMIT_CONT / COMMIT_ACCEPT / COMMIT_TERM; None in the table means
    auto-accept, the behavior of the reference's shipped anyhit shader)

The default shaders below reproduce shaders/closest.cpp, shaders/miss.cpp
and shaders/anyhit.cpp exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import jax.numpy as jnp

from vortex_rt_tpu.ops.shade_lanes import (
    ShadeArrays, ShadePoint, diffuse_lighting_lanes, reflect_lanes,
)
from vortex_rt_tpu.utils.config import COMMIT_ACCEPT


class ShaderContext(NamedTuple):
    """kernel_arg_t analog handed to every shader (common.h:164-195)."""

    shade: ShadeArrays
    light_pos: jnp.ndarray      # (3,)
    light_color: jnp.ndarray    # (3,)
    ambient: jnp.ndarray        # (3,)
    background: jnp.ndarray     # (3,)
    max_depth: int
    seed: jnp.ndarray = jnp.uint32(0)  # sampler stream (utils.sampling)


class RayLanes(NamedTuple):
    ox: jnp.ndarray; oy: jnp.ndarray; oz: jnp.ndarray
    dx: jnp.ndarray; dy: jnp.ndarray; dz: jnp.ndarray


class PayloadLanes(NamedTuple):
    """ray_payload_t analog (shaders/shader.h), extended with the
    per-lane sample index so stochastic shaders can draw deterministic
    counter-based randoms (utils.sampling)."""

    throughput: jnp.ndarray  # (R,) luminance throughput (RGB in engine)
    bounce: jnp.ndarray      # (R,) i32
    pixel: jnp.ndarray       # (R,) i32
    sample: jnp.ndarray      # (R,) u32 global sample index


class ClosestOut(NamedTuple):
    """What a closest-hit shader contributes back to the engine.

    ``mul_*`` is the RGB throughput multiplier for the spawned ray
    (scalar reflectivity in the Whitted shader; colored albedo for
    path-traced diffuse bounces)."""

    add_r: jnp.ndarray; add_g: jnp.ndarray; add_b: jnp.ndarray
    mul_r: jnp.ndarray; mul_g: jnp.ndarray; mul_b: jnp.ndarray
    spawn: jnp.ndarray            # (R,) bool: emit a secondary ray
    sox: jnp.ndarray; soy: jnp.ndarray; soz: jnp.ndarray
    sdx: jnp.ndarray; sdy: jnp.ndarray; sdz: jnp.ndarray


def default_closest(ctx: ShaderContext, sp: ShadePoint, ray: RayLanes,
                    payload: PayloadLanes) -> ClosestOut:
    """shaders/closest.cpp semantics: attenuated diffuse + reflective
    bounce, remaining throughput to the environment when not bouncing."""
    dr, dg, db = diffuse_lighting_lanes(
        sp, ctx.light_pos, ctx.light_color, ctx.ambient)
    refl = sp.reflectivity
    one_m = 1.0 - refl
    spawn = (refl > 0.0) & (payload.bounce + 1 < ctx.max_depth)
    # non-spawning rays dump remaining (post-reflectivity) energy into the
    # background (closest.cpp:122-125 / render.h:268-271)
    bg_r = jnp.where(spawn, 0.0, refl * ctx.background[0])
    bg_g = jnp.where(spawn, 0.0, refl * ctx.background[1])
    bg_b = jnp.where(spawn, 0.0, refl * ctx.background[2])
    rx, ry, rz = reflect_lanes(ray.dx, ray.dy, ray.dz, sp.nx, sp.ny, sp.nz)
    return ClosestOut(
        add_r=one_m * dr + bg_r,
        add_g=one_m * dg + bg_g,
        add_b=one_m * db + bg_b,
        mul_r=refl, mul_g=refl, mul_b=refl,
        spawn=spawn,
        sox=sp.px + rx * 1e-3, soy=sp.py + ry * 1e-3, soz=sp.pz + rz * 1e-3,
        sdx=rx, sdy=ry, sdz=rz,
    )


def pathtrace_closest(ctx: ShaderContext, sp: ShadePoint, ray: RayLanes,
                      payload: PayloadLanes) -> ClosestOut:
    """Path-traced closest hit (BASELINE configs 3-4 "spp path trace"):
    next-event-estimated direct light (shadow-gated via sp.lit, same as
    the Whitted shader), then a sampled continuation — a mirror ray where
    reflectivity > 0, else a cosine-weighted diffuse bounce with the
    albedo as throughput weight (BRDF*cos/pdf == albedo for Lambertian).

    Randoms are counter-based (utils.sampling) on (pixel, sample, bounce,
    ctx.seed): the NumPy golden path tracer replays the exact same
    stream, so device-vs-oracle image parity holds at any spp.  The
    ambient term fires only at the primary hit (it is an approximation of
    the indirect light the later bounces now compute for real)."""
    from vortex_rt_tpu.utils import sampling as sam

    dr, dg, db = diffuse_lighting_lanes(
        sp, ctx.light_pos, ctx.light_color,
        jnp.zeros(3, jnp.float32))
    first = payload.bounce == 0
    amb = jnp.where(first, 1.0, 0.0)
    dr = dr + amb * ctx.ambient[0] * sp.color_r
    dg = dg + amb * ctx.ambient[1] * sp.color_g
    db = db + amb * ctx.ambient[2] * sp.color_b

    refl = sp.reflectivity
    mirror = refl > 0.0
    # stream key is the GLOBAL sample index (payload.sample — frame seeds
    # fold into it, engine.wavefront.frame_body), not ctx.seed: this way
    # render_accum(k passes x s spp) replays the identical sample set as
    # one spp=k*s frame, and the golden oracle needs no per-pass seeds
    u1, u2 = sam.sample2(jnp, payload.pixel.astype(jnp.uint32),
                         payload.sample, payload.bounce.astype(jnp.uint32),
                         0, dim=1)
    hx, hy, hz = sam.cosine_hemisphere(jnp, sp.nx, sp.ny, sp.nz, u1, u2)
    rx, ry, rz = reflect_lanes(ray.dx, ray.dy, ray.dz, sp.nx, sp.ny, sp.nz)
    sdx = jnp.where(mirror, rx, hx)
    sdy = jnp.where(mirror, ry, hy)
    sdz = jnp.where(mirror, rz, hz)
    mul_r = jnp.where(mirror, refl, sp.color_r)
    mul_g = jnp.where(mirror, refl, sp.color_g)
    mul_b = jnp.where(mirror, refl, sp.color_b)
    spawn = payload.bounce + 1 < ctx.max_depth
    # Russian roulette from the second bounce on: survive with p =
    # max throughput component (clipped), compensate by 1/p — unbiased
    # term truncation that retires ~40% of deep bounce rays before they
    # hit the (dominant) incoherent trace waves.  Counter-based draw
    # (dim=2): the golden oracle replays the identical kill decisions,
    # so device-vs-oracle parity stays bit-tight.
    u3, _ = sam.sample2(jnp, payload.pixel.astype(jnp.uint32),
                        payload.sample, payload.bounce.astype(jnp.uint32),
                        0, dim=2)
    p_srv = jnp.clip(jnp.maximum(mul_r, jnp.maximum(mul_g, mul_b)),
                     0.1, 0.95)
    rr = payload.bounce >= 1
    survive = jnp.where(rr, u3 < p_srv, True)
    inv_p = jnp.where(rr, 1.0 / p_srv, 1.0)
    one_m = 1.0 - refl
    return ClosestOut(
        add_r=one_m * dr, add_g=one_m * dg, add_b=one_m * db,
        mul_r=mul_r * inv_p, mul_g=mul_g * inv_p, mul_b=mul_b * inv_p,
        spawn=spawn & survive,
        sox=sp.px + sdx * 1e-3, soy=sp.py + sdy * 1e-3,
        soz=sp.pz + sdz * 1e-3,
        sdx=sdx, sdy=sdy, sdz=sdz,
    )


def default_miss(ctx: ShaderContext, ray: RayLanes, payload: PayloadLanes):
    """shaders/miss.cpp: payload color = background, terminate."""
    r = jnp.ones_like(ray.dx)
    return (ctx.background[0] * r, ctx.background[1] * r,
            ctx.background[2] * r)


def alpha_test_anyhit(threshold: float = 0.5):
    """Texture-driven alpha cutout through the suspension protocol.

    The reference's shipped anyhit.cpp is a stub (alpha hardcoded 1.0, so
    it always ACCEPTs); this one does the real thing the stub gestures
    at: sample the surface texture at the candidate hit (sp.color_* is
    the texSample result at the suspended intersection's interpolated
    uv) and treat its luminance as alpha — below ``threshold`` the hit is
    rejected (COMMIT_CONT: traversal resumes past the surface,
    rt_unit.cpp:190-213), at or above it the hit is accepted."""

    def shader(ctx: ShaderContext, sp: ShadePoint, ray: RayLanes,
               payload: PayloadLanes):
        alpha = (0.2126 * sp.color_r + 0.7152 * sp.color_g
                 + 0.0722 * sp.color_b)
        return jnp.where(alpha < threshold,
                         jnp.int32(0),   # COMMIT_CONT (reject)
                         jnp.int32(COMMIT_ACCEPT)).astype(jnp.int32)

    # declarative marker: the packet engine evaluates this exact test
    # IN-LOOP (trace_packets alpha_ref) instead of falling back to the
    # per-ray suspension pool; the per-ray facade (rtu.py /
    # packet=0) still runs the callable through the suspension protocol
    shader.alpha_threshold = float(threshold)
    return shader


def stateless_anyhit(pred: Callable, name: str = "stateless"):
    """Arbitrary STATELESS any-hit shader at packet speed.

    The reference runs any any-hit shader binary through per-ray
    suspension (rt_unit.cpp:190-213 CONT/ACCEPT + shaders/anyhit.cpp
    entry) — generality paid for with a per-ray engine.  Most real
    any-hit shaders (alpha cutouts, procedural masks) are PURE
    per-candidate predicates: accept/reject depends only on the
    candidate intersection, not on mutable per-ray state.  For those,
    ``pred(u, v, alpha) -> keep`` evaluates INSIDE the packet traversal
    loop (trace_packets anyhit_pred):

    * ``u, v``  — the candidate's interpolated texture coordinates
      (uv1*bx + uv2*by + uv0*bz, closest.cpp:77 order);
    * ``alpha`` — the luminance of the surface color shade_point would
      compute there (point-sampled texel, or material diffuse when
      untextured);
    * return ``keep``: False = COMMIT_CONT (reject, traversal
      continues past the surface), True = candidate enters the
      closest-hit fold (COMMIT_ACCEPT when it wins).

    ``pred`` must be jax-traceable and elementwise over its operands.
    The returned shader ALSO implements the identical decision through
    the per-ray suspension protocol, so non-packet pipelines (packet=0,
    TLAS builds, rtu.py facade) and parity tests run the same cutout.
    Truly stateful any-hit shaders (payload accumulation, ordered
    transparency) write a plain ``ShaderTable.anyhit`` callable instead
    and keep the suspension engine."""

    def shader(ctx: ShaderContext, sp: ShadePoint, ray: RayLanes,
               payload: PayloadLanes):
        alpha = (0.2126 * sp.color_r + 0.7152 * sp.color_g
                 + 0.0722 * sp.color_b)
        keep = pred(sp.u, sp.v, alpha)
        return jnp.where(keep, jnp.int32(COMMIT_ACCEPT),
                         jnp.int32(0)).astype(jnp.int32)  # 0 = CONT

    shader.inline_predicate = pred
    shader.__name__ = f"stateless_anyhit_{name}"
    return shader


@dataclasses.dataclass(frozen=True)
class ShaderTable:
    """The SBT.  ``anyhit=None`` keeps the engine on the auto-accept fast
    path (no suspension round-trips), exactly equivalent to the shipped
    always-accept shader."""

    closest: Callable = default_closest
    miss: Callable = default_miss
    anyhit: Optional[Callable] = None
    # the closest shader's continuation (spawn/sox..sdz/mul) must not
    # depend on sp.lit for the engine's merged shadow+bounce wave (the
    # occlusion result then only selects between lit=0/1 ADD terms).
    # Both shipped closest shaders qualify; set False for a custom
    # shader whose spawn logic reads sp.lit and the engine falls back
    # to sequential shadow->shade->bounce waves
    lit_independent_spawn: bool = True
