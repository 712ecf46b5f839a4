"""Lane-form shading: packed shade tables + the reference's shader bodies.

The wavefront engine shades hit batches once per bounce.  Like the
traversal engine (ops.traverse_wide), everything is (R,) component lanes
and per-ray data is packed into 16-float rows so one shaded ray costs three
row gathers (triangle attributes, material, instance) plus one texel
gather:

* ``shade_rows``   (T, 16): n0, n1, n2 (9) + uv0, uv1, uv2 (6) + mat(bits)
  — the tri_ex_t payload (common.h:39-46) in slot order
* ``mat_rows``     (M, 16): diffuse rgb, tex_offset(bits), tex_w(bits),
  tex_h(bits), ambient rgb, specular rgb, emissive rgb, shininess
  — material_info_t (common.h:20-36)
* ``inst_shade``   (I, 16): inverse-transpose 3x3 (9) + reflectivity
  — the blas_node_t shading fields (common.h:85-103)

Shader bodies reproduce shaders/closest.cpp, shaders/miss.cpp and
rtx_shading.h texSample/diffuseLighting exactly (see ops.shade for the
formula citations).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from vortex_rt_tpu.models.scene import SceneBuffers


def _bits_f32(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.astype(np.int32)).view(np.float32)


def _bitcast_i32(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ShadeArrays:
    """Device shading tables (kernel_arg_t buffer analog for shaders)."""

    shade_rows: jnp.ndarray  # (T, 16) f32, slot order = traversal slot order
    mat_rows: jnp.ndarray    # (M, 16) f32
    inst_shade: jnp.ndarray  # (I, 16) f32
    texels: jnp.ndarray      # (X,) u32 0xRRGGBB pool

    @staticmethod
    def from_scene(sb: SceneBuffers) -> "ShadeArrays":
        # IMPORTANT: rows are in *global triangle id* order (the traversal
        # reports global ids via slot_tri), not slot order.
        t = sb.v0.shape[0]
        rows = np.zeros((t, 16), np.float32)
        rows[:, 0:3] = sb.n0
        rows[:, 3:6] = sb.n1
        rows[:, 6:9] = sb.n2
        rows[:, 9:11] = sb.uv0
        rows[:, 11:13] = sb.uv1
        rows[:, 13:15] = sb.uv2
        rows[:, 15] = _bits_f32(sb.mat_id)

        m = sb.mat_diffuse.shape[0]
        mat = np.zeros((m, 16), np.float32)
        mat[:, 0:3] = sb.mat_diffuse
        mat[:, 3] = _bits_f32(sb.mat_tex_offset)
        mat[:, 4] = _bits_f32(sb.mat_tex_w)
        mat[:, 5] = _bits_f32(sb.mat_tex_h)
        mat[:, 6:9] = sb.mat_ambient
        mat[:, 9:12] = sb.mat_specular
        mat[:, 12:15] = sb.mat_emissive
        mat[:, 15] = sb.mat_shininess

        i = sb.inst_inv_transpose.shape[0]
        ins = np.zeros((i, 16), np.float32)
        ins[:, 0:9] = sb.inst_inv_transpose[:, :3, :3].reshape(i, 9)
        ins[:, 9] = sb.inst_reflectivity

        return ShadeArrays(
            shade_rows=jnp.asarray(rows),
            mat_rows=jnp.asarray(mat),
            inst_shade=jnp.asarray(ins),
            texels=jnp.asarray(sb.texels.astype(np.uint32)),
        )


class Lanes3(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    @staticmethod
    def of(a3):
        return Lanes3(a3[:, 0], a3[:, 1], a3[:, 2])

    def scale(self, s):
        return Lanes3(self.x * s, self.y * s, self.z * s)

    def add(self, o):
        return Lanes3(self.x + o.x, self.y + o.y, self.z + o.z)


def _normalize(x, y, z, eps=1e-20):
    # exact sqrt + divide, not lax.rsqrt: an approximate reciprocal
    # square root would cost golden parity
    inv = 1.0 / jnp.sqrt(x * x + y * y + z * z + eps)
    return x * inv, y * inv, z * inv


class ShadePoint(NamedTuple):
    """Everything the closest-hit/any-hit shader can getAttr
    (VX_RT_* attr ids, hw/VX_types.toml:270-285)."""

    px: jnp.ndarray; py: jnp.ndarray; pz: jnp.ndarray   # hit point
    nx: jnp.ndarray; ny: jnp.ndarray; nz: jnp.ndarray   # shading normal
    u: jnp.ndarray; v: jnp.ndarray                       # interpolated uv
    color_r: jnp.ndarray; color_g: jnp.ndarray; color_b: jnp.ndarray
    reflectivity: jnp.ndarray
    mat: jnp.ndarray
    tri: jnp.ndarray
    inst: jnp.ndarray
    lit: jnp.ndarray  # 1.0 = light visible, 0.0 = shadowed (shadow rays)


def _tex_fetch(sa: ShadeArrays, idx):
    """(R,) texel-pool index -> RGB f32 lanes (RGB8toRGB32F, common.h)."""
    texel = sa.texels[jnp.clip(idx, 0, sa.texels.shape[0] - 1)]
    s = jnp.float32(1.0 / 256.0)
    return (((texel >> 16) & 255).astype(jnp.float32) * s,
            ((texel >> 8) & 255).astype(jnp.float32) * s,
            (texel & 255).astype(jnp.float32) * s)


def shade_point(sa: ShadeArrays,
                ox, oy, oz, dx, dy, dz,
                dist, bx, by, bz, tri, inst,
                bilinear: bool = False) -> ShadePoint:
    """Fetch + interpolate everything at a hit (closest.cpp:60-83).

    ``bilinear=True`` switches the texel fetch from point sampling
    (rtx_shading.h texSample) to the reference's bilinear filter
    (texSampleBi, raycast/render.h:24-56: floor first, wrap each of the
    four taps independently)."""
    t = jnp.minimum(dist, 1e18)
    px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t

    # gathered records are transposed ONCE and sliced by row: extracting
    # a column from a (R, 16) gather is a strided relayout while a
    # (16, R) row slice is contiguous — ARCHITECTURE.md rule 2, same
    # layout trick as the traversal engines' node fetch
    row = sa.shade_rows[tri].T
    # N = N1*bx + N2*by + N0*bz (closest.cpp:71)
    nx = row[3] * bx + row[6] * by + row[0] * bz
    ny = row[4] * bx + row[7] * by + row[1] * bz
    nz = row[5] * bx + row[8] * by + row[2] * bz
    irow = sa.inst_shade[inst].T
    # normals transform by the instance's inverse-transpose (closest.cpp:72)
    tnx = irow[0] * nx + irow[1] * ny + irow[2] * nz
    tny = irow[3] * nx + irow[4] * ny + irow[5] * nz
    tnz = irow[6] * nx + irow[7] * ny + irow[8] * nz
    nx, ny, nz = _normalize(tnx, tny, tnz)

    # uv = uv1*bx + uv2*by + uv0*bz (closest.cpp:77)
    u = row[11] * bx + row[13] * by + row[9] * bz
    v = row[12] * bx + row[14] * by + row[10] * bz

    mat = _bitcast_i32(row[15])
    mrow = sa.mat_rows[mat].T
    toff = _bitcast_i32(mrow[3])
    tw = jnp.maximum(_bitcast_i32(mrow[4]), 1)
    th = jnp.maximum(_bitcast_i32(mrow[5]), 1)
    has_tex = toff >= 0
    if not bilinear:
        iu = jnp.floor(u * tw).astype(jnp.int32) % tw
        iv = jnp.floor(v * th).astype(jnp.int32) % th
        tex_idx = jnp.where(has_tex, toff + iu + iv * tw, 0)
        tr, tg, tb = _tex_fetch(sa, tex_idx)
    else:
        uu = u * tw
        vv = v * th
        x0 = jnp.floor(uu)
        y0 = jnp.floor(vv)
        fu = (uu - x0).astype(jnp.float32)
        fv = (vv - y0).astype(jnp.float32)
        x0i = x0.astype(jnp.int32) % tw
        y0i = y0.astype(jnp.int32) % th
        x1i = (x0.astype(jnp.int32) + 1) % tw
        y1i = (y0.astype(jnp.int32) + 1) % th

        def tap(xi, yi):
            return _tex_fetch(sa, jnp.where(has_tex, toff + xi + yi * tw, 0))

        c00 = tap(x0i, y0i)
        c10 = tap(x1i, y0i)
        c01 = tap(x0i, y1i)
        c11 = tap(x1i, y1i)
        tr, tg, tb = (
            (c00[k] * (1 - fu) + c10[k] * fu) * (1 - fv)
            + (c01[k] * (1 - fu) + c11[k] * fu) * fv
            for k in range(3))
    cr = jnp.where(has_tex, tr, mrow[0])
    cg = jnp.where(has_tex, tg, mrow[1])
    cb = jnp.where(has_tex, tb, mrow[2])

    return ShadePoint(px=px, py=py, pz=pz, nx=nx, ny=ny, nz=nz, u=u, v=v,
                      color_r=cr, color_g=cg, color_b=cb,
                      reflectivity=irow[9], mat=mat, tri=tri, inst=inst,
                      lit=jnp.ones_like(px))


def diffuse_lighting_lanes(sp: ShadePoint, light_pos, light_color, ambient):
    """rtx_shading.h diffuseLighting on lanes: att = 1/(1 + 0.1*dist).
    ``sp.lit`` gates the direct term (shadow rays); ambient is unshadowed."""
    lx = light_pos[0] - sp.px
    ly = light_pos[1] - sp.py
    lz = light_pos[2] - sp.pz
    dist = jnp.sqrt(lx * lx + ly * ly + lz * lz + 1e-20)
    inv = 1.0 / dist
    ndotl = jnp.maximum(0.0, (sp.nx * lx + sp.ny * ly + sp.nz * lz) * inv)
    att = 1.0 / (1.0 + dist * 0.1)
    f = att * ndotl * sp.lit
    return (sp.color_r * (ambient[0] + light_color[0] * f),
            sp.color_g * (ambient[1] + light_color[1] * f),
            sp.color_b * (ambient[2] + light_color[2] * f))


def reflect_lanes(dx, dy, dz, nx, ny, nz):
    """R = normalize(d - 2 n (n.d)) (closest.cpp:103)."""
    nd = nx * dx + ny * dy + nz * dz
    rx = dx - 2.0 * nd * nx
    ry = dy - 2.0 * nd * ny
    rz = dz - 2.0 * nd * nz
    return _normalize(rx, ry, rz)
