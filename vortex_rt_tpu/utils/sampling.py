"""Deterministic counter-based sampler shared by the device and the oracle.

The reference has no stochastic sampling (its GenerateRay shoots pixel
centers, raycast/render.h:190-208); BASELINE configs 3-4 add "4/8 spp
path trace", which needs per-(pixel, sample, bounce) random numbers.  We
use a stateless PCG-style integer hash implemented ONCE over a generic
array namespace so ``jnp`` (device) and ``np`` (golden oracle) produce
BIT-IDENTICAL streams — the oracle can then replay the exact same light
paths and image parity holds at any spp, which is a far stronger gate
than comparing noisy estimates in expectation.

All functions take uint32 arrays (or python ints) and are pure integer
arithmetic: no PRNG state threading, no jax.random key plumbing through
the wavefront loop — plain integer vector ops that XLA fuses.
"""

from __future__ import annotations

import numpy as np

_M1 = 747796405
_M2 = 2891336453
_M3 = 277803737
_GOLD = 0x9E3779B9    # 2^32 / phi
_MIX = 0x85EBCA6B


def _u32(xp, v):
    return xp.asarray(v).astype(xp.uint32) if not hasattr(v, "astype") \
        else v.astype(xp.uint32)


def pcg(xp, v):
    """PCG output permutation (O'Neill's pcg32 variant, public domain
    construction): uint32 -> well-mixed uint32."""
    v = _u32(xp, v)
    state = v * xp.uint32(_M1) + xp.uint32(_M2)
    word = ((state >> ((state >> xp.uint32(28)) + xp.uint32(4))) ^ state) \
        * xp.uint32(_M3)
    return (word >> xp.uint32(22)) ^ word


def hash3(xp, a, b, c):
    """Mix three uint32 streams into one (order-sensitive).  Scalars are
    broadcast to ``a``'s shape first — NumPy wraps silently only for
    ndim >= 1 arrays (scalar wraparound raises RuntimeWarnings)."""
    a = _u32(xp, a)
    z = xp.zeros_like(a)
    b = _u32(xp, b) + z
    c = _u32(xp, c) + z
    h = pcg(xp, a ^ xp.uint32(_GOLD))
    h = pcg(xp, h + b * xp.uint32(_MIX))
    return pcg(xp, h + c * xp.uint32(_GOLD))


def u01(xp, bits):
    """uint32 -> float32 in [0, 1): top 24 bits scaled (fp32-exact)."""
    return (bits >> xp.uint32(8)).astype(xp.float32) * xp.float32(
        1.0 / 16777216.0)


def sample2(xp, pixel, sample, bounce, seed, dim=0):
    """Two independent uniforms in [0,1) per (pixel, sample, bounce, dim).

    ``pixel``/``sample``/``bounce`` may be arrays (broadcast together);
    ``seed``/``dim`` scalars.  Same bits under np and jnp.
    """
    dim_mix = (int(dim) * 0x632BE59B) & 0xFFFFFFFF  # python-int, no overflow
    pixel = _u32(xp, pixel)
    z = xp.zeros_like(pixel)  # broadcast scalars: silent uint32 wraparound
    sample = _u32(xp, sample) + z
    seed = _u32(xp, seed) + z
    base = hash3(xp, pixel, sample + xp.uint32(dim_mix),
                 (_u32(xp, bounce) + z) ^ pcg(xp, seed))
    return u01(xp, base), u01(xp, pcg(xp, base ^ xp.uint32(_GOLD)))


def stratified_jitter(xp, pixel, sample, total_spp: int, seed):
    """Sub-pixel (jx, jy) in [0,1)^2: sample s lands in cell s of a
    ceil(sqrt(total_spp))^2 stratum grid, jittered inside the cell.
    total_spp == 1 returns exact pixel centers (reference GenerateRay
    parity)."""
    if total_spp == 1:
        half = xp.float32(0.5)
        return (xp.zeros_like(_u32(xp, pixel), dtype=xp.float32) + half,
                xp.zeros_like(_u32(xp, pixel), dtype=xp.float32) + half)
    g = int(np.ceil(np.sqrt(total_spp)))
    s = _u32(xp, sample) % xp.uint32(total_spp)
    cx = (s % xp.uint32(g)).astype(xp.float32)
    cy = (s // xp.uint32(g)).astype(xp.float32)
    u, v = sample2(xp, pixel, sample, 0, seed, dim=7)
    inv_g = xp.float32(1.0 / g)
    return (cx + u) * inv_g, (cy + v) * inv_g


def cosine_hemisphere(xp, nx, ny, nz, u1, u2):
    """Cosine-weighted direction about the (unit) normal.

    Branch-free Frisvad-style orthonormal basis; returns (dx, dy, dz).
    pdf = cos(theta)/pi, so Lambertian throughput weight is exactly the
    albedo (BRDF * cos / pdf = albedo).
    """
    # ONB (handles nz ~ -1 via the sign trick)
    sign = xp.where(nz >= 0.0, xp.float32(1.0), xp.float32(-1.0))
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t1x = 1.0 + sign * nx * nx * a
    t1y = sign * b
    t1z = -sign * nx
    t2x = b
    t2y = sign + ny * ny * a
    t2z = -ny
    two_pi = xp.float32(2.0 * np.pi)
    r = xp.sqrt(u1)
    phi = two_pi * u2
    x = r * xp.cos(phi)
    y = r * xp.sin(phi)
    z = xp.sqrt(xp.maximum(xp.float32(0.0), 1.0 - u1))
    return (x * t1x + y * t2x + z * nx,
            x * t1y + y * t2y + z * ny,
            x * t1z + y * t2z + z * nz)
