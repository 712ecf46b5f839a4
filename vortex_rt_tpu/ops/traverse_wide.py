"""Wide quantized BVH traversal with restart trail + short stack (JAX).

This is the production traceRay engine: a faithful re-implementation of the
reference RT unit's traversal algorithm (BVHTraverser,
sim/simx/rt_traversal.cpp:26-213) — 4-wide quantized two-level TLAS/BLAS,
far-to-near child ordering, restart trail over 32 levels, 5-entry short
stack, any-hit suspension — re-expressed as array programs.  The layout
rules below (docs/ARCHITECTURE.md rules 1-5) were decided on the earlier
platform and are unmeasured on the H100:

* ONE 64-byte packed node row per traversal step: one row gather instead
  of many scalar gathers — so the node is packed into 16 uint32 words exactly like
  the reference's 64-byte bvh_quantized_node_t (common.h:56-67): fp32
  origin, fp32 per-axis power-of-two scale, per-child 3x-uint8 quantized
  bounds packed one u32 per child, and a meta word
  (kind | nchild | left_first).
* Everything inside the loop is an (R,) component lane: no array axis
  of length 3, so rays, boxes and barycentrics are separate x/y/z
  lanes.
* The traversal trail (reference: array<u32,32>) is bit-packed 4 bits/
  level into four (R,) uint32 lanes; the 5-entry short stack
  (ShortStack<.,5>, types.h:1809-1840) is a shift register of five (R,)
  int32 lanes.  Per-lane 2-D indexing ``x[lanes, j]`` appears nowhere.
* Triangles are pre-gathered into leaf-slot order as (T,16) rows
  (v0, e1, e2, tri-id) so a leaf step is one contiguous row gather;
  instances are (I,16) rows (inverse transform + BLAS root).
* Device arrays are jit ARGUMENTS, never Python closures — closed-over
  arrays become jaxpr constants and destroy both compile and run time.

Semantics matched to the reference (file:line):
* child cull ``d < hit.dist`` strict            rt_traversal.cpp:72
* far->near sort, drop trail[level] closest     rt_traversal.cpp:76-90
  (trail==WIDTH keeps only the farthest)
* push remaining far-first, farthest flagged
  'last'; descend closest; trail[level]=WIDTH
  when nothing left to push                     rt_traversal.cpp:93-105
* TLAS leaf -> object-space ray + BLAS jump     rt_traversal.cpp:110-121
* any-hit suspension: on a strictly closer hit
  record pending, clear stack, suspend          rt_traversal.cpp:139-159
* pop: deepest trail level != WIDTH, ++, zero
  deeper, stack pop or root restart             rt_traversal.cpp:179-213

One deliberate fix over the reference: resuming after a COMMIT_CONT
(reject) would livelock in the reference (the same intersection re-fires —
its shipped any-hit shader always accepts, so the path is untested there).
We keep a per-ray lexicographic (t, tri) barrier tied to the in-progress
leaf, so rejected intersections are presented exactly once, in order.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vortex_rt_tpu.accel import qbvh
from vortex_rt_tpu.models.scene import SceneBuffers
from vortex_rt_tpu.ops.traverse2 import Hits, PerfCounters
from vortex_rt_tpu.utils.config import LARGE_FLOAT, MT_EPSILON

WIDTH = qbvh.WIDTH
LAST_FLAG = np.int32(1 << 30)
ID_MASK = np.int32((1 << 30) - 1)
_INT_MAX = np.int32(2**31 - 1)
_MISS = np.float32(-LARGE_FLOAT)  # sort key for culled children (desc sort)

# meta word layout, width 4 (slot 14): left_first | nchild << 26 | kind << 29
_LEFT_BITS = 26
_LEFT_MASK = (1 << _LEFT_BITS) - 1
# meta word layout, width 8 (slot 22): left_first | nchild << 25 | kind << 29
# (nchild needs 4 bits for 8 children; left budget drops to 25 bits = 32M)
_LEFT_BITS8 = 25
_LEFT_MASK8 = (1 << _LEFT_BITS8) - 1
# meta word layout, width 16 (slot 38): left_first | nchild << 24 | kind << 29
# (nchild needs 5 bits for 16 children; left budget 24 bits = 16M nodes)
_LEFT_BITS16 = 24
_LEFT_MASK16 = (1 << _LEFT_BITS16) - 1

# physical words per packed node row (>= _row_layout base, padded so the
# row gather stays 128-byte aligned for widths 4/8; 16-wide needs 40)
_ROW_WORDS = {4: 32, 8: 32, 16: 40}


def _row_layout(width: int):
    """Packed node-row geometry: (qlo_off, qhi_off, meta_off, leaf_off,
    base) where ``base`` is the first word after the node fields (the
    instance block for width 4, or inline leaf fields when fused)."""
    if width == 4:
        return 6, 10, 14, 15, 16
    if width == 8:
        return 6, 14, 22, 23, 24
    assert width == 16
    return 6, 22, 38, 39, 40


def _meta_bits_for(width: int):
    """(left_bits, nchild_mask) of the packed meta word."""
    return {4: (_LEFT_BITS, 7), 8: (_LEFT_BITS8, 15),
            16: (_LEFT_BITS16, 31)}[width]


# ---------------------------------------------------------------------------
# device arrays
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class WideArrays:
    """Packed wide TLAS+BLAS pool + slot-ordered triangle/instance rows."""

    nodes: jnp.ndarray      # (N, 32) u32 packed node records; instance
                            # leaves carry their inverse transform + BLAS
                            # root inline in words 16..28
    tri_rows: jnp.ndarray   # (L, 64) f32: one row per tri leaf = up to 4x
                            # (v0, e1, e2, tid(bits), pad) 16-float slots
    num_tlas: int = dataclasses.field(metadata=dict(static=True))
    max_leaf_tris: int = dataclasses.field(metadata=dict(static=True))
    depth: int = dataclasses.field(metadata=dict(static=True))
    # flattened build (SceneBuffers.flat): no TLAS/instance nodes; leaf
    # tids pack (inst << tri_bits) | tri.  0 = TLAS mode (unpacked ids)
    tri_bits: int = dataclasses.field(default=0,
                                      metadata=dict(static=True))
    # children per node (4 or 8); 8-wide requires the flattened build
    # (instance rows don't fit next to 8 child boxes in a 128-byte row)
    width: int = dataclasses.field(default=4, metadata=dict(static=True))
    # optional fused node+leaf table (N, 32 + 16*max_leaf_tris) u32:
    # row i = node record ++ (its inline tri-leaf slots if KIND_TRIS).
    # One gather serves BOTH loop paths per step — same bytes as the two
    # dependent gathers (node row + leaf row), half the gather ops and
    # no serial dependency.  Built by .fuse(); used when present.
    fused: Optional[jnp.ndarray] = dataclasses.field(default=None)
    # optional alpha-cutout tables (built by .with_alpha): per leaf slot
    # the uv triple + texture window, and a per-texel alpha (luminance)
    # pool — lets trace_packets evaluate the alpha-test any-hit INSIDE
    # the traversal loop (in-loop analog of shaders/anyhit.cpp +
    # rt_unit.cpp:190-213 CONT/ACCEPT, without per-ray suspension)
    alpha_rows: Optional[jnp.ndarray] = dataclasses.field(default=None)
    # (L, 8*lmax) f32: u0,v0,u1,v1,u2,v2,toff(bits),(tw<<16|th)(bits)
    alpha_pool: Optional[jnp.ndarray] = dataclasses.field(default=None)
    # (X + M,) f32: luminance per texel, then per-material diffuse
    # luminance (the untextured fallback, addressed as a 1x1 texture)

    def with_alpha(self, sb: SceneBuffers) -> "WideArrays":
        """Build the in-loop alpha-test tables (host-side, NumPy).

        The alpha of a candidate hit is the luminance of the surface
        color shade_point would compute there (point-sampled texel, or
        the material diffuse when untextured) — numerically IDENTICAL
        to what alpha_test_anyhit sees through the suspension protocol,
        so the two any-hit paths accept/reject the same candidates."""
        lum = (np.float32(0.2126), np.float32(0.7152), np.float32(0.0722))

        texels = np.asarray(sb.texels).astype(np.uint32)
        s = np.float32(1.0 / 256.0)
        tr = ((texels >> 16) & 255).astype(np.float32) * s
        tg = ((texels >> 8) & 255).astype(np.float32) * s
        tb = (texels & 255).astype(np.float32) * s
        a_tex = lum[0] * tr + lum[1] * tg + lum[2] * tb
        md = np.asarray(sb.mat_diffuse, np.float32)
        a_mat = lum[0] * md[:, 0] + lum[1] * md[:, 1] + lum[2] * md[:, 2]
        pool = np.concatenate([a_tex, a_mat]).astype(np.float32)
        n_tex = int(texels.shape[0])

        tids = self.leaf_tids                        # (L, slots), -1 empty
        lmax = tids.shape[1]
        tri = tids & ((1 << self.tri_bits) - 1) if self.tri_bits else tids
        tri = np.clip(tri, 0, sb.v0.shape[0] - 1)
        mat = np.asarray(sb.mat_id)[tri]
        toff = np.asarray(sb.mat_tex_offset)[mat].astype(np.int64)
        has_tex = toff >= 0
        tw = np.where(has_tex, np.asarray(sb.mat_tex_w)[mat], 1)
        th = np.where(has_tex, np.asarray(sb.mat_tex_h)[mat], 1)
        toff = np.where(has_tex, toff, n_tex + mat).astype(np.int32)
        # empty slots: point at material 0's constant (never read: the
        # MT candidate mask already excludes them)
        rows = np.zeros((tids.shape[0], 8 * lmax), np.float32)
        uv0 = np.asarray(sb.uv0, np.float32)
        uv1 = np.asarray(sb.uv1, np.float32)
        uv2 = np.asarray(sb.uv2, np.float32)
        for c in range(lmax):
            rows[:, 8 * c + 0: 8 * c + 2] = uv0[tri[:, c]]
            rows[:, 8 * c + 2: 8 * c + 4] = uv1[tri[:, c]]
            rows[:, 8 * c + 4: 8 * c + 6] = uv2[tri[:, c]]
            rows[:, 8 * c + 6] = toff[:, c].view(np.float32)
            rows[:, 8 * c + 7] = ((tw[:, c].astype(np.int32) << 16)
                                  | th[:, c].astype(np.int32)).view(
                                      np.float32)
        out = dataclasses.replace(
            self, alpha_rows=jnp.asarray(rows), alpha_pool=jnp.asarray(pool))
        if self.fused is not None:
            # extend the fused rows with the alpha fields so the any-hit
            # leaf step stays at ONE chained node-row gather (the alpha
            # row would otherwise be a second gather at the same chain
            # depth; the texel-pool gather that depends on it is then
            # the only extra chain level — rule 33: chained gathers cost
            # D x the one-gather time, so depth matters, not row width)
            out = dataclasses.replace(out, fused=None).fuse()
        return out

    def _meta_bits(self):
        return _meta_bits_for(self.width)

    def fuse(self) -> "WideArrays":
        """Return a copy with the fused node+leaf table built (flat
        builds only).  jnp ops throughout, so it works on device and
        under jit (the LBVH refit path)."""
        assert self.num_tlas == 0 and self.tri_bits > 0, \
            "fused rows require the flattened build"
        moff = _row_layout(self.width)[2]
        lmax = max(int(self.max_leaf_tris), 1)
        nodes = jnp.asarray(self.nodes)
        meta = nodes[:, moff]
        kind = (meta >> 29).astype(jnp.int32)
        lb, _ = self._meta_bits()
        left = (meta & ((1 << lb) - 1)).astype(jnp.int32)
        rows = jax.lax.bitcast_convert_type(
            jnp.asarray(self.tri_rows), jnp.uint32)
        n = nodes.shape[0]
        is_tris = kind == qbvh.KIND_TRIS
        safe = jnp.clip(left, 0, rows.shape[0] - 1)
        leaf_part = jnp.where(is_tris[:, None], rows[safe],
                              jnp.zeros((n, 16 * lmax), jnp.uint32))
        parts = [nodes, leaf_part]
        if self.alpha_rows is not None:
            # carry the alpha-test fields in the same row (see with_alpha)
            arows = jax.lax.bitcast_convert_type(
                jnp.asarray(self.alpha_rows), jnp.uint32)
            parts.append(jnp.where(is_tris[:, None], arows[safe],
                                   jnp.zeros((n, 8 * lmax), jnp.uint32)))
        return dataclasses.replace(
            self, fused=jnp.concatenate(parts, axis=1))

    # ---- host-side unpacked views (tests / debugging) ----
    @property
    def kind(self) -> np.ndarray:
        moff = _row_layout(self.width)[2]
        return (np.asarray(self.nodes[:, moff]) >> 29).astype(np.int32)

    @property
    def nchild(self) -> np.ndarray:
        moff = _row_layout(self.width)[2]
        lb, nm = self._meta_bits()
        return ((np.asarray(self.nodes[:, moff]) >> lb) & nm).astype(np.int32)

    @property
    def left_first(self) -> np.ndarray:
        moff = _row_layout(self.width)[2]
        lb, _ = self._meta_bits()
        mask = (1 << lb) - 1
        return (np.asarray(self.nodes[:, moff]) & mask).astype(np.int32)

    @property
    def leaf_data(self) -> np.ndarray:
        loff = _row_layout(self.width)[3]
        return np.asarray(self.nodes[:, loff]).view(np.int32)

    @property
    def origin(self) -> np.ndarray:
        return np.asarray(self.nodes[:, 0:3]).view(np.float32)

    @property
    def scale(self) -> np.ndarray:
        return np.asarray(self.nodes[:, 3:6]).view(np.float32)

    @property
    def qlo(self) -> np.ndarray:
        qoff, hoff = _row_layout(self.width)[:2]
        q = np.asarray(self.nodes[:, qoff:hoff])
        return np.stack([(q >> s) & 255 for s in (0, 8, 16)],
                        axis=-1).reshape(-1, self.width * 3).astype(np.uint8)

    @property
    def qhi(self) -> np.ndarray:
        qoff, hoff, moff = _row_layout(self.width)[:3]
        q = np.asarray(self.nodes[:, hoff:moff])
        return np.stack([(q >> s) & 255 for s in (0, 8, 16)],
                        axis=-1).reshape(-1, self.width * 3).astype(np.uint8)

    @property
    def leaf_tids(self) -> np.ndarray:
        """(L, slots) global tri id per leaf slot (-1 = empty)."""
        r = np.asarray(self.tri_rows)
        return np.stack([r[:, 16 * c + 9] for c in range(r.shape[1] // 16)],
                        axis=1).view(np.int32)

    @staticmethod
    def from_scene(sb: SceneBuffers, width: int = 4) -> "WideArrays":
        flat = bool(getattr(sb, "flat", False))
        assert width in (4, 8, 16), f"unsupported BVH width {width}"
        assert width == 4 or flat, \
            "8/16-wide nodes require the flattened build (RTConfig.flatten)"
        tri_bits = 0
        if flat:
            # flattened scene: ONE world-space BLAS, no TLAS/instance
            # nodes; leaf tids pack (inst << tri_bits) | tri so hits
            # keep per-instance material/shading ids
            wb = qbvh.collapse_flat(
                sb.bvh_min, sb.bvh_max, sb.bvh_left, sb.bvh_count,
                roots=[0], leaf_kind=qbvh.KIND_TRIS, width=width,
            )
            k = 0
            origin = wb.origin.astype(np.float32)
            scale = wb.scale.astype(np.float32)
            qlo = wb.qlo.astype(np.uint32)
            qhi = wb.qhi.astype(np.uint32)
            nchild = wb.nchild.astype(np.uint32)
            kind = wb.kind.astype(np.uint32)
            left = wb.left_first.astype(np.int64)
            leaf = wb.leaf_data.astype(np.int64)
            depth = int(wb.depth)
            t = int(sb.v0.shape[0])
            tri_bits = max(int(np.ceil(np.log2(max(t, 2)))), 1)
            n_inst = int(sb.inst_bvh_root.shape[0])
            assert ((n_inst - 1) << tri_bits) | (t - 1) < (1 << 31), \
                "inst << tri_bits exceeds the i32 leaf-id budget"
            tid_pack = ((sb.tri_inst.astype(np.int64) << tri_bits)
                        | np.arange(t, dtype=np.int64)).astype(np.int32)
        else:
            # wide TLAS over the binary TLAS (leaves -> instance ids)
            wt = qbvh.collapse_flat(
                sb.tlas_min, sb.tlas_max, sb.tlas_left, sb.tlas_count,
                roots=[0], leaf_kind=qbvh.KIND_INSTANCE,
                leaf_payload=sb.tlas_inst_idx,
            )
            # wide BLAS pool over the packed per-mesh binary trees
            mesh_roots = sorted(set(int(r) for r in sb.inst_bvh_root))
            wb = qbvh.collapse_flat(
                sb.bvh_min, sb.bvh_max, sb.bvh_left, sb.bvh_count,
                roots=mesh_roots, leaf_kind=qbvh.KIND_TRIS,
            )
            k = wt.num_nodes
            root_of = {r: int(wb.roots[i]) + k
                       for i, r in enumerate(mesh_roots)}
            inst_root = np.asarray(
                [root_of[int(r)] for r in sb.inst_bvh_root], np.int32)

            def cat(a, b):
                return np.concatenate([a, b])

            origin = cat(wt.origin, wb.origin).astype(np.float32)
            scale = cat(wt.scale, wb.scale).astype(np.float32)
            qlo = cat(wt.qlo, wb.qlo).astype(np.uint32)
            qhi = cat(wt.qhi, wb.qhi).astype(np.uint32)
            nchild = cat(wt.nchild, wb.nchild).astype(np.uint32)
            kind = cat(wt.kind, wb.kind).astype(np.uint32)
            left = cat(
                wt.left_first,
                np.where(wb.kind == qbvh.KIND_INTERNAL,
                         wb.left_first + k, wb.left_first),
            ).astype(np.int64)
            leaf = cat(wt.leaf_data, wb.leaf_data).astype(np.int64)
            depth = int(wt.depth + wb.depth)
        n = origin.shape[0]

        max_leaf = max(int(sb.bvh_count.max()), 1)

        # ---- one packed row per triangle leaf (row gathers cost per ROW
        # on this hardware, so a whole leaf costs one gather) ----
        is_leaf = kind == qbvh.KIND_TRIS
        leaf_ids = np.nonzero(is_leaf)[0]
        n_leaves = max(len(leaf_ids), 1)
        first = left[leaf_ids].astype(np.int64)
        cnt = leaf[leaf_ids].astype(np.int64)
        lmax = max(max_leaf, 4)
        slots = np.clip(first[:, None] + np.arange(lmax)[None, :], 0,
                        sb.bvh_tri_idx.shape[0] - 1)
        valid = np.arange(lmax)[None, :] < cnt[:, None]
        tid = sb.bvh_tri_idx[slots].astype(np.int32)
        tid_out = tid_pack[tid] if flat else tid  # packed (inst|tri) ids
        v0 = sb.v0[tid]
        e1 = sb.v1[tid] - v0
        e2 = sb.v2[tid] - v0
        zero = ~valid[..., None]
        v0 = np.where(zero, 0.0, v0)
        e1 = np.where(zero, 0.0, e1)  # degenerate: |a| < eps, never hits
        e2 = np.where(zero, 0.0, e2)
        tri_rows = np.zeros((n_leaves, 16 * lmax), np.float32)
        for c in range(lmax):
            tri_rows[: len(leaf_ids), 16 * c : 16 * c + 3] = v0[:, c]
            tri_rows[: len(leaf_ids), 16 * c + 3 : 16 * c + 6] = e1[:, c]
            tri_rows[: len(leaf_ids), 16 * c + 6 : 16 * c + 9] = e2[:, c]
            tri_rows[: len(leaf_ids), 16 * c + 9] = np.where(
                valid[:, c], tid_out[:, c], -1).astype(np.int32).view(np.float32)
        # rebase tri-leaf left_first to the leaf-row index
        leaf_row_of = np.zeros(n, np.int64)
        leaf_row_of[leaf_ids] = np.arange(len(leaf_ids))
        left = np.where(is_leaf, leaf_row_of, left)
        lb = _meta_bits_for(width)[0]
        assert (left >= 0).all() and (left < (1 << lb)).all(), \
            f"node/leaf pool exceeds {lb}-bit left_first budget"

        qoff, hoff, moff, loff, _ = _row_layout(width)
        nodes = np.zeros((n, _ROW_WORDS[width]), np.uint32)
        nodes[:, 0:3] = origin.view(np.uint32)
        nodes[:, 3:6] = scale.view(np.uint32)
        for c in range(width):
            nodes[:, qoff + c] = (qlo[:, 3 * c] | (qlo[:, 3 * c + 1] << 8)
                                  | (qlo[:, 3 * c + 2] << 16))
            nodes[:, hoff + c] = (qhi[:, 3 * c] | (qhi[:, 3 * c + 1] << 8)
                                  | (qhi[:, 3 * c + 2] << 16))
        nodes[:, moff] = (left.astype(np.uint32)
                          | (nchild << lb) | (kind << 29))
        nodes[:, loff] = leaf.astype(np.uint32)
        if not flat:
            # instance leaves carry their inverse transform + BLAS root
            is_inst = kind == qbvh.KIND_INSTANCE
            iids = left[is_inst].astype(np.int64)
            nodes[is_inst, 16:28] = sb.inst_inv_transform[iids, :3, :] \
                .reshape(-1, 12).astype(np.float32).view(np.uint32)
            nodes[is_inst, 28] = inst_root[iids].view(np.uint32)

        assert depth < 63, f"combined BVH depth {depth} exceeds trail budget"

        return WideArrays(
            nodes=jnp.asarray(nodes),
            tri_rows=jnp.asarray(tri_rows),
            num_tlas=int(k),
            max_leaf_tris=max_leaf,
            depth=depth,
            tri_bits=tri_bits,
            width=width,
        )


# ---------------------------------------------------------------------------
# trail: 4 bits/level, 8 levels per uint32 word, 8 words = 64 levels
# (the reference's MAX_TRAIL_LEVEL is 32; we carry 64 so deep binary LBVH
# trees fit — 4 extra u32 lanes cost nothing)
# ---------------------------------------------------------------------------

TRAIL_WORDS = 8

def _u32(x):
    return x.astype(jnp.uint32)


def trail_get(tr, level):
    sh = _u32((level & 7) * 4)
    widx = level >> 3
    w = tr[0]
    for i in range(1, TRAIL_WORDS):
        w = jnp.where(widx == i, tr[i], w)
    return ((w >> sh) & jnp.uint32(0xF)).astype(jnp.int32)


def trail_set(tr, level, val, mask):
    sh = _u32((level & 7) * 4)
    widx = level >> 3
    out = []
    for i in range(TRAIL_WORDS):
        neww = (tr[i] & ~(jnp.uint32(0xF) << sh)) | (_u32(val) << sh)
        out.append(jnp.where(mask & (widx == i), neww, tr[i]))
    return tuple(out)


def trail_clear_above(tr, p, mask):
    """Zero every level > p (rt_traversal.cpp:194-196)."""
    out = []
    for i in range(TRAIL_WORDS):
        k = jnp.clip(p + 1 - 8 * i, 0, 8)
        sh = _u32(jnp.minimum(k * 4, 31))
        keep = jnp.where(k >= 8, jnp.uint32(0xFFFFFFFF),
                         (jnp.uint32(1) << sh) - jnp.uint32(1))
        out.append(jnp.where(mask, tr[i] & keep, tr[i]))
    return tuple(out)


def trail_find_parent(tr, level):
    """Deepest l < level with trail[l] != WIDTH, else -1
    (findNextParentLevel, rt_traversal.cpp:170-177).  Values are in [0, 4];
    ==4 iff the nibble's bit2 is set, so != 4 <=> bit (4l+2) clear."""
    best = jnp.full(level.shape, -1, jnp.int32)
    for i in range(TRAIL_WORDS):
        cand = (~tr[i]) & jnp.uint32(0x44444444)
        k = jnp.clip(level - 8 * i, 0, 8)
        sh = _u32(jnp.minimum(k * 4, 31))
        limit = jnp.where(k >= 8, jnp.uint32(0xFFFFFFFF),
                          (jnp.uint32(1) << sh) - jnp.uint32(1))
        cand = cand & limit
        hb = 31 - jax.lax.clz(cand.astype(jnp.int32))  # -1 when cand == 0
        lvl = 8 * i + (hb >> 2)
        best = jnp.where(cand != 0, lvl.astype(jnp.int32), best)
    return best


# ---------------------------------------------------------------------------
# short stack: shift register of 5 (R,) lanes (ShortStack semantics)
# ---------------------------------------------------------------------------

def stack_push(st, count, entry, mask):
    s0, s1, s2, s3, s4 = st
    ns = (
        jnp.where(mask, entry, s0),
        jnp.where(mask, s0, s1),
        jnp.where(mask, s1, s2),
        jnp.where(mask, s2, s3),
        jnp.where(mask, s3, s4),  # oldest falls off on overflow
    )
    return ns, jnp.where(mask, jnp.minimum(count + 1, 5), count)


def stack_pop(st, count, mask):
    s0, s1, s2, s3, s4 = st
    ns = (
        jnp.where(mask, s1, s0),
        jnp.where(mask, s2, s1),
        jnp.where(mask, s3, s2),
        jnp.where(mask, s4, s3),
        jnp.where(mask, jnp.zeros_like(s4), s4),
    )
    return s0, ns, jnp.where(mask, count - 1, count)


def _at_pos(vals, pos):
    """vals[pos] for a small tuple of (R,) lanes without 2-D indexing."""
    r = vals[0]
    for i in range(1, len(vals)):
        r = jnp.where(pos == i, vals[i], r)
    return r


_GATHER_CHUNK = 4096


def _gather_rows(tbl, idx):
    """Row gather (a plain gather: the per-ray engine is fed
    ``RTConfig.lanes``-sized chunks at the batch level, see
    engine.wavefront)."""
    return tbl[idx]


def _bitcast_f32(x):
    return jax.lax.bitcast_convert_type(x, jnp.float32)


def _bitcast_i32(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


def _rcp_lane(d, eps: float = 1e-20):
    return 1.0 / jnp.where(jnp.abs(d) < eps, jnp.where(d < 0, -eps, eps), d)


# ---------------------------------------------------------------------------
# traversal state: every field is an (R,) lane
# ---------------------------------------------------------------------------

class WideState(NamedTuple):
    node: jnp.ndarray
    level: jnp.ndarray
    tr0: jnp.ndarray; tr1: jnp.ndarray; tr2: jnp.ndarray; tr3: jnp.ndarray
    tr4: jnp.ndarray; tr5: jnp.ndarray; tr6: jnp.ndarray; tr7: jnp.ndarray
    s0: jnp.ndarray; s1: jnp.ndarray; s2: jnp.ndarray
    s3: jnp.ndarray; s4: jnp.ndarray
    scount: jnp.ndarray
    inst: jnp.ndarray
    lox: jnp.ndarray; loy: jnp.ndarray; loz: jnp.ndarray
    ldx: jnp.ndarray; ldy: jnp.ndarray; ldz: jnp.ndarray
    lix: jnp.ndarray; liy: jnp.ndarray; liz: jnp.ndarray
    best_t: jnp.ndarray
    bx: jnp.ndarray; by: jnp.ndarray
    tri: jnp.ndarray
    best_inst: jnp.ndarray
    # any-hit machinery (suspend mode)
    bar_t: jnp.ndarray; bar_tid: jnp.ndarray; bar_leaf: jnp.ndarray
    pend_t: jnp.ndarray; pend_bx: jnp.ndarray; pend_by: jnp.ndarray
    pend_tri: jnp.ndarray; pend_inst: jnp.ndarray
    suspended: jnp.ndarray
    done: jnp.ndarray
    nodes_visited: jnp.ndarray
    tri_tests: jnp.ndarray
    steps: jnp.ndarray


def init_state(r: int, o, d, t_max: float = LARGE_FLOAT) -> WideState:
    return init_state_lanes(o[:, 0], o[:, 1], o[:, 2],
                            d[:, 0], d[:, 1], d[:, 2], t_max)


def init_state_lanes(ox, oy, oz, dx, dy, dz,
                     t_max: float = LARGE_FLOAT) -> WideState:
    r = ox.shape[0]
    zi = jnp.zeros(r, jnp.int32)
    zu = jnp.zeros(r, jnp.uint32)
    zf = jnp.zeros(r, jnp.float32)
    zb = jnp.zeros(r, bool)
    return WideState(
        node=zi, level=zi,
        tr0=zu, tr1=zu, tr2=zu, tr3=zu, tr4=zu, tr5=zu, tr6=zu, tr7=zu,
        s0=zi, s1=zi, s2=zi, s3=zi, s4=zi, scount=zi,
        inst=zi,
        lox=ox, loy=oy, loz=oz, ldx=dx, ldy=dy, ldz=dz,
        lix=_rcp_lane(dx), liy=_rcp_lane(dy), liz=_rcp_lane(dz),
        best_t=jnp.full(r, t_max, jnp.float32),
        bx=zf, by=zf, tri=zi, best_inst=zi,
        bar_t=jnp.full(r, -LARGE_FLOAT, jnp.float32),
        bar_tid=jnp.full(r, -1, jnp.int32),
        bar_leaf=jnp.full(r, -1, jnp.int32),
        pend_t=jnp.full(r, LARGE_FLOAT, jnp.float32),
        pend_bx=zf, pend_by=zf, pend_tri=zi, pend_inst=zi,
        suspended=zb, done=zb,
        nodes_visited=zi, tri_tests=zi, steps=jnp.int32(0),
    )


def trace_rays_wide(
    wa: WideArrays,
    o: jnp.ndarray,
    d: jnp.ndarray,
    state: Optional[WideState] = None,
    suspend: bool = False,
    max_steps: int = 200_000,
    t_max: float = LARGE_FLOAT,
) -> Tuple[Hits, WideState, PerfCounters]:
    """Trace a ray batch to completion (or to any-hit suspension).

    With ``suspend=False`` every closer hit is auto-accepted (the shipped
    any-hit shader's behavior, shaders/anyhit.cpp alpha==1 path) and rays
    run to completion.  With ``suspend=True`` rays pause on each strictly
    closer intersection with pending hit info filled (rt_unit ANY queue
    analog); resume by passing the (committed) state back in.
    """
    return trace_lanes(wa, o[:, 0], o[:, 1], o[:, 2],
                       d[:, 0], d[:, 1], d[:, 2],
                       state=state, suspend=suspend, max_steps=max_steps,
                       t_max=t_max)


def trace_lanes(
    wa: WideArrays,
    ox, oy, oz, dx, dy, dz,
    state: Optional[WideState] = None,
    suspend: bool = False,
    max_steps: int = 200_000,
    t_max: float = LARGE_FLOAT,
) -> Tuple[Hits, WideState, PerfCounters]:
    """Lane-form entry point (see trace_rays_wide)."""
    # flattened arrays pack (inst << tri_bits) | tri into leaf ids; the
    # packed i32 compare IS the (inst, tri) lexicographic tie-break, so
    # auto-accept traversal works unchanged (hits unpack at return).
    # The suspension protocol, however, presents tri ids to any-hit
    # shaders mid-walk — packed ids cannot survive that round trip
    assert not (wa.tri_bits and suspend), \
        "flattened WideArrays require the packet engine (no any-hit)"
    # the per-ray engine stays 4-wide (its trail nibbles encode 0..4 and
    # the restart machinery assumes it); 8-wide runs in the packet engine
    assert wa.width == 4, "per-ray traversal requires width-4 WideArrays"
    r = ox.shape[0]
    if state is None:
        state = init_state_lanes(ox, oy, oz, dx, dy, dz, t_max)
    ivx, ivy, ivz = _rcp_lane(dx), _rcp_lane(dy), _rcp_lane(dz)
    n_pool = int(wa.nodes.shape[0])
    n_leaf_rows = int(wa.tri_rows.shape[0])
    lmax = max(int(wa.max_leaf_tris), 1)
    eps = jnp.float32(MT_EPSILON)

    def cond(s: WideState):
        return jnp.logical_and(
            jnp.any(~s.done & ~s.suspended), s.steps < max_steps)

    def body(s: WideState) -> WideState:
        active = ~s.done & ~s.suspended
        node = jnp.clip(s.node, 0, n_pool - 1)
        row = _gather_rows(wa.nodes, node)         # (R, 32) — THE node gather
        # one fused relayout: a single transpose then row slices instead
        # of one strided column extract per field (ARCHITECTURE.md rule 2)
        rowt = row.T                                # (32, R)
        meta = rowt[14]
        kind = (meta >> 29).astype(jnp.int32)
        nch = ((meta >> _LEFT_BITS) & 7).astype(jnp.int32)
        left = (meta & _LEFT_MASK).astype(jnp.int32)
        leaf_data = _bitcast_i32(rowt[15])
        is_int = active & (kind == qbvh.KIND_INTERNAL)
        is_tri = active & (kind == qbvh.KIND_TRIS)
        is_ins = active & (kind == qbvh.KIND_INSTANCE)
        in_tlas = node < wa.num_tlas
        trail = (s.tr0, s.tr1, s.tr2, s.tr3, s.tr4, s.tr5, s.tr6, s.tr7)
        stack = (s.s0, s.s1, s.s2, s.s3, s.s4)
        scount = s.scount

        # current-space ray lanes (world in the TLAS, object in a BLAS)
        rox = jnp.where(in_tlas, ox, s.lox)
        roy = jnp.where(in_tlas, oy, s.loy)
        roz = jnp.where(in_tlas, oz, s.loz)
        rdx = jnp.where(in_tlas, dx, s.ldx)
        rdy = jnp.where(in_tlas, dy, s.ldy)
        rdz = jnp.where(in_tlas, dz, s.ldz)
        rix = jnp.where(in_tlas, ivx, s.lix)
        riy = jnp.where(in_tlas, ivy, s.liy)
        riz = jnp.where(in_tlas, ivz, s.liz)

        # ================= internal node =================
        gx, gy, gz = (_bitcast_f32(rowt[0]), _bitcast_f32(rowt[1]),
                      _bitcast_f32(rowt[2]))
        sx, sy, sz = (_bitcast_f32(rowt[3]), _bitcast_f32(rowt[4]),
                      _bitcast_f32(rowt[5]))
        dists, idxs = [], []
        for c in range(WIDTH):
            ql = rowt[6 + c]
            qh = rowt[10 + c]
            lx = gx + (ql & 255).astype(jnp.float32) * sx
            ly = gy + ((ql >> 8) & 255).astype(jnp.float32) * sy
            lz = gz + ((ql >> 16) & 255).astype(jnp.float32) * sz
            hx = gx + (qh & 255).astype(jnp.float32) * sx
            hy = gy + ((qh >> 8) & 255).astype(jnp.float32) * sy
            hz = gz + ((qh >> 16) & 255).astype(jnp.float32) * sz
            t1x = (lx - rox) * rix; t2x = (hx - rox) * rix
            t1y = (ly - roy) * riy; t2y = (hy - roy) * riy
            t1z = (lz - roz) * riz; t2z = (hz - roz) * riz
            tmin = jnp.maximum(
                jnp.maximum(jnp.minimum(t1x, t2x), jnp.minimum(t1y, t2y)),
                jnp.minimum(t1z, t2z))
            tmax = jnp.minimum(
                jnp.minimum(jnp.maximum(t1x, t2x), jnp.maximum(t1y, t2y)),
                jnp.maximum(t1z, t2z))
            hc = ((tmax >= tmin) & (tmax > 0.0)
                  & (c < nch) & (tmin < s.best_t))
            dists.append(jnp.where(hc, tmin, _MISS))
            idxs.append(jnp.full(r, c, jnp.int32))
        m = sum((dd > _MISS).astype(jnp.int32) for dd in dists)

        # 5-swap sorting network, descending (far -> near; culled last)
        for a_i, b_i in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
            swap = dists[a_i] < dists[b_i]
            da, db = dists[a_i], dists[b_i]
            ia, ib = idxs[a_i], idxs[b_i]
            dists[a_i] = jnp.where(swap, db, da)
            dists[b_i] = jnp.where(swap, da, db)
            idxs[a_i] = jnp.where(swap, ib, ia)
            idxs[b_i] = jnp.where(swap, ia, ib)

        k_tr = trail_get(trail, s.level)
        drop = jnp.where(k_tr == WIDTH, jnp.maximum(m - 1, 0),
                         jnp.minimum(k_tr, m))
        remaining = m - drop
        pos_closest = m - 1 - drop
        descend = is_int & (remaining >= 1)
        want_pop_int = is_int & (remaining < 1)
        child_slot = _at_pos(idxs, pos_closest)
        next_int = left + child_slot

        # pushes: sorted positions 0..pos_closest-1, farthest (pos 0) first
        # and flagged 'last' (rt_traversal.cpp:99-104)
        push_entries = [
            (descend & (pos_closest >= 1), (left + idxs[0]) | LAST_FLAG),
            (descend & (pos_closest >= 2), left + idxs[1]),
            (descend & (pos_closest >= 3), left + idxs[2]),
        ]
        for pm, pe in push_entries:
            stack, scount = stack_push(stack, scount, pe, pm)
        trail = trail_set(trail, s.level, jnp.full(r, WIDTH, jnp.int32),
                          descend & (remaining == 1))

        # ================= instance leaf =================
        # inverse transform + BLAS root live inline in the node row
        iid = left
        mm = [_bitcast_f32(rowt[16 + k]) for k in range(12)]
        m00, m01, m02, m03 = mm[0], mm[1], mm[2], mm[3]
        m10, m11, m12, m13 = mm[4], mm[5], mm[6], mm[7]
        m20, m21, m22, m23 = mm[8], mm[9], mm[10], mm[11]
        nlox = m00 * ox + m01 * oy + m02 * oz + m03
        nloy = m10 * ox + m11 * oy + m12 * oz + m13
        nloz = m20 * ox + m21 * oy + m22 * oz + m23
        nldx = m00 * dx + m01 * dy + m02 * dz
        nldy = m10 * dx + m11 * dy + m12 * dz
        nldz = m20 * dx + m21 * dy + m22 * dz
        inst = jnp.where(is_ins, iid, s.inst)
        lox = jnp.where(is_ins, nlox, s.lox)
        loy = jnp.where(is_ins, nloy, s.loy)
        loz = jnp.where(is_ins, nloz, s.loz)
        ldx_ = jnp.where(is_ins, nldx, s.ldx)
        ldy_ = jnp.where(is_ins, nldy, s.ldy)
        ldz_ = jnp.where(is_ins, nldz, s.ldz)
        lix = jnp.where(is_ins, _rcp_lane(nldx), s.lix)
        liy = jnp.where(is_ins, _rcp_lane(nldy), s.liy)
        liz = jnp.where(is_ins, _rcp_lane(nldz), s.liz)
        next_ins = _bitcast_i32(rowt[28])

        # ================= triangle leaf =================
        # one 256-byte row carries the whole leaf (up to 4 triangles)
        lrow = _gather_rows(wa.tri_rows,
                            jnp.clip(left, 0, n_leaf_rows - 1)).T  # (64, R)
        cnt = leaf_data

        if suspend:
            barrier = (node == s.bar_leaf)
        t_min = jnp.full(r, LARGE_FLOAT)
        tid_sel = jnp.full(r, _INT_MAX)
        w1_sel = jnp.zeros(r, jnp.float32)
        w2_sel = jnp.zeros(r, jnp.float32)

        for c in range(lmax):
            b0 = 16 * c
            v0x, v0y, v0z = lrow[b0], lrow[b0 + 1], lrow[b0 + 2]
            e1x, e1y, e1z = lrow[b0 + 3], lrow[b0 + 4], lrow[b0 + 5]
            e2x, e2y, e2z = lrow[b0 + 6], lrow[b0 + 7], lrow[b0 + 8]
            tid = _bitcast_i32(lrow[b0 + 9])
            # Moller-Trumbore on lanes (rt_traversal.cpp:263-316)
            hx_ = ldy_ * e2z - ldz_ * e2y
            hy_ = ldz_ * e2x - ldx_ * e2z
            hz_ = ldx_ * e2y - ldy_ * e2x
            a = e1x * hx_ + e1y * hy_ + e1z * hz_
            fba = 1.0 / jnp.where(jnp.abs(a) < eps, 1.0, a)
            sx_ = lox - v0x; sy_ = loy - v0y; sz_ = loz - v0z
            w1 = fba * (sx_ * hx_ + sy_ * hy_ + sz_ * hz_)
            qx = sy_ * e1z - sz_ * e1y
            qy = sz_ * e1x - sx_ * e1z
            qz = sx_ * e1y - sy_ * e1x
            w2 = fba * (ldx_ * qx + ldy_ * qy + ldz_ * qz)
            t = fba * (e2x * qx + e2y * qy + e2z * qz)
            ok = ((jnp.abs(a) >= eps) & (w1 >= 0.0) & (w1 <= 1.0)
                  & (w2 >= 0.0) & (w1 + w2 <= 1.0) & (t > eps)
                  & (c < cnt) & is_tri)
            if suspend:
                beyond = (~barrier) | (t > s.bar_t) | (
                    (t == s.bar_t) & (tid > s.bar_tid))
                ok = ok & (t < s.best_t) & beyond
            t = jnp.where(ok, t, LARGE_FLOAT)
            better = (t < t_min) | ((t == t_min) & (t < LARGE_FLOAT)
                                    & (tid < tid_sel))
            t_min = jnp.where(better, t, t_min)
            tid_sel = jnp.where(better, tid, tid_sel)
            w1_sel = jnp.where(better, w1, w1_sel)
            w2_sel = jnp.where(better, w2, w2_sel)

        if suspend:
            found = is_tri & (t_min < LARGE_FLOAT)
            pend_t = jnp.where(found, t_min, s.pend_t)
            pend_bx = jnp.where(found, w1_sel, s.pend_bx)
            pend_by = jnp.where(found, w2_sel, s.pend_by)
            pend_tri = jnp.where(found, tid_sel, s.pend_tri)
            pend_inst = jnp.where(found, inst, s.pend_inst)
            suspended = s.suspended | found
            # reference clears the stack at suspension (rt_traversal.cpp:151)
            zi = jnp.zeros(r, jnp.int32)
            stack = tuple(jnp.where(found, zi, st) for st in stack)
            scount = jnp.where(found, 0, scount)
            best_t, bxl, byl, tri, best_inst = (
                s.best_t, s.bx, s.by, s.tri, s.best_inst)
            want_pop_tri = is_tri & ~found
        else:
            closer = is_tri & (t_min < s.best_t)
            tie = is_tri & (t_min == s.best_t) & (t_min < LARGE_FLOAT)
            tie_better = tie & ((inst < s.best_inst)
                                | ((inst == s.best_inst) & (tid_sel < s.tri)))
            upd = closer | tie_better
            best_t = jnp.where(upd, t_min, s.best_t)
            bxl = jnp.where(upd, w1_sel, s.bx)
            byl = jnp.where(upd, w2_sel, s.by)
            tri = jnp.where(upd, tid_sel, s.tri)
            best_inst = jnp.where(upd, inst, s.best_inst)
            pend_t, pend_bx, pend_by = s.pend_t, s.pend_bx, s.pend_by
            pend_tri, pend_inst = s.pend_tri, s.pend_inst
            suspended = s.suspended
            want_pop_tri = is_tri

        # ================= choose next / pop =================
        nxt = jnp.where(is_int, jnp.where(descend, next_int, s.node),
                        jnp.where(is_ins, next_ins, s.node))
        level = jnp.where(descend, s.level + 1, s.level)

        want_pop = want_pop_int | want_pop_tri
        p = trail_find_parent(trail, level)
        dead = want_pop & (p < 0)
        do_pop = want_pop & (p >= 0)
        p_safe = jnp.maximum(p, 0)
        kp = trail_get(trail, p_safe)
        trail = trail_set(trail, p_safe, kp + 1, do_pop)
        trail = trail_clear_above(trail, p_safe, do_pop)
        empty = scount == 0
        restart = do_pop & empty
        from_stack = do_pop & ~empty
        entry, stack, scount = stack_pop(stack, scount, from_stack)
        is_last = (entry & LAST_FLAG) != 0
        trail = trail_set(trail, p_safe, jnp.full(r, WIDTH, jnp.int32),
                          from_stack & is_last)
        nxt = jnp.where(restart, 0, jnp.where(from_stack, entry & ID_MASK, nxt))
        level = jnp.where(restart, 0,
                          jnp.where(from_stack, p_safe + 1, level))
        done = s.done | dead

        return WideState(
            node=nxt, level=level,
            tr0=trail[0], tr1=trail[1], tr2=trail[2], tr3=trail[3],
            tr4=trail[4], tr5=trail[5], tr6=trail[6], tr7=trail[7],
            s0=stack[0], s1=stack[1], s2=stack[2], s3=stack[3], s4=stack[4],
            scount=scount, inst=inst,
            lox=lox, loy=loy, loz=loz,
            ldx=ldx_, ldy=ldy_, ldz=ldz_,
            lix=lix, liy=liy, liz=liz,
            best_t=best_t, bx=bxl, by=byl, tri=tri, best_inst=best_inst,
            bar_t=s.bar_t, bar_tid=s.bar_tid, bar_leaf=s.bar_leaf,
            pend_t=pend_t, pend_bx=pend_bx, pend_by=pend_by,
            pend_tri=pend_tri, pend_inst=pend_inst,
            suspended=suspended, done=done,
            nodes_visited=s.nodes_visited + active.astype(jnp.int32),
            tri_tests=s.tri_tests
            + jnp.where(is_tri, cnt, 0).astype(jnp.int32),
            steps=s.steps + 1,
        )

    final = jax.lax.while_loop(cond, body, state)
    if wa.tri_bits:
        # unpack (inst << tri_bits) | tri (miss lanes carry 0 -> (0, 0))
        tri_out = final.tri & ((1 << wa.tri_bits) - 1)
        inst_out = final.tri >> wa.tri_bits
    else:
        tri_out, inst_out = final.tri, final.best_inst
    hits = Hits(
        dist=final.best_t,
        bx=final.bx, by=final.by, bz=1.0 - final.bx - final.by,
        tri=tri_out, inst=inst_out,
    )
    perf = PerfCounters(final.nodes_visited, final.tri_tests, final.steps)
    return hits, final, perf


def commit(state: WideState, action: jnp.ndarray) -> WideState:
    """Apply per-ray commit actions to a suspended batch
    (RTUnit::commit semantics, rt_unit.cpp:190-213).

    action: (R,) i32 of COMMIT_CONT / COMMIT_ACCEPT / COMMIT_TERM
    (utils.config).  Only suspended rays are affected.  After commit, rays
    are un-suspended (CONT/ACCEPT resume traversal; TERM is done).
    """
    from vortex_rt_tpu.utils.config import (
        COMMIT_ACCEPT, COMMIT_TERM,
    )

    sus = state.suspended
    acc = sus & (action == COMMIT_ACCEPT)
    term = sus & (action == COMMIT_TERM)
    moved = sus & (action != COMMIT_TERM)  # CONT or ACCEPT resume
    best_t = jnp.where(acc, state.pend_t, state.best_t)
    bx = jnp.where(acc, state.pend_bx, state.bx)
    by = jnp.where(acc, state.pend_by, state.by)
    tri = jnp.where(acc, state.pend_tri, state.tri)
    best_inst = jnp.where(acc, state.pend_inst, state.best_inst)
    # barrier: the presented intersection is consumed either way
    bar_t = jnp.where(moved, state.pend_t, state.bar_t)
    bar_tid = jnp.where(moved, state.pend_tri, state.bar_tid)
    bar_leaf = jnp.where(moved, state.node, state.bar_leaf)
    return state._replace(
        best_t=best_t, bx=bx, by=by, tri=tri, best_inst=best_inst,
        bar_t=bar_t, bar_tid=bar_tid, bar_leaf=bar_leaf,
        suspended=state.suspended & ~sus,
        done=state.done | term,
    )
