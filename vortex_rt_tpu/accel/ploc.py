"""LBVH v3: triangle-level PLOC build with in-loop leaf formation.

Why: v2 (Karras radix-median + subtree-cut leaves, accel.lbvh) is
restricted to splitting CONTIGUOUS Morton ranges, and that restriction
is the measured 2x packet-step tax vs the host binned-SAH tree (round-4
diagnosis: even sweep-SAH over the same Morton order only reaches
2.04x — the ordering constraint is the problem, not the split rule).
A cluster-level PLOC over the v2 cut leaves was built and measured
first: 1.59x — better, but capped by the cut-leaf granularity itself
(the cut emits ~3.4x more leaf rows than the SAH builder packs).

Fix: PLOC from TRIANGLES (Meister & Bittner 2018, "Parallel
Locally-Ordered Clustering for Bounding Volume Hierarchy Construction"
— agglomerative mutual-nearest-neighbor merging, the standard GPU
builder for near-SAH quality at LBVH cost), with leaves formed INSIDE
the loop: merging two leaf-clusters whose combined count fits
``leaf_size`` just concatenates their triangle lists; a merge that
would overflow materializes leaf rows for its leaf-cluster sides and
allocates an internal node.  Leaf membership and tree topology are
therefore BOTH chosen by spatial clustering — no Morton-contiguity
constraint anywhere (leaf rows gather arbitrary triangle ids).
Measured on the 100k wavy-grid gate (oblique packets): 1.17x SAH
packet-steps at radius 16 (1.23x at radius 8) vs 2.07x for v2, with
leaf-row counts matching the SAH builder (30.3k vs 29.3k; the cut-leaf
variant emitted 99.5k).  tests/test_ploc.py gates <= 1.5x HARD.

Static-shape discipline: one `lax.while_loop` whose state is fixed-size
(l,) arrays + a traced live-cluster count; each iteration computes all
(l, radius) windowed pair costs as shifted vector ops, merges mutual
nearest neighbors with prefix-sum slot allocation, and compacts
survivors to the array front with one stable argsort.  Mutual-NN
merges ~1/3 of clusters per iteration (~60-90 iterations at 1M tris);
an even/odd pair fallback guarantees progress against pathological
cost ties.

The result reuses the SAME depth-stride wide collapse + quantized
packing as v2 (`_pack_wide`), so the traversal engine sees an
identical node format.  Refit (config-5 animation): leaf boxes reduce
over the explicit per-row triangle ids; internal boxes sweep by
CREATION LEVEL (children are created in strictly earlier iterations,
so level order is a topological order — no fixed-point iteration).

Reference semantics matched: the host binned-SAH builder's tree
quality (tests/regression/raytracing/bvh.cpp:30-109) with the
on-device build the reference lacks (BASELINE configs 3 and 5).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from vortex_rt_tpu.accel.lbvh import (
    LBVHNodes, LBVHTopo, _half_area, _pack_wide, morton3d, pad_tris,
)

_BIG = jnp.float32(3e38)


class PLOCTopo(NamedTuple):
    """Fixed PLOC topology for rebuild-free repacking / level refit."""

    topo: LBVHTopo        # collapse/pack fields (lo/hi/row_lo unused)
    leaf_tids: jnp.ndarray  # (l, leaf_size) SORTED-ORDER slot per row
                            # (-1 pad): global tri id = topo.order[slot]
    level: jnp.ndarray    # (l-1,) creation iteration per OLD internal
    n_int: jnp.ndarray    # () live internal count
    n_levels: jnp.ndarray  # () iterations the merge loop ran


def _merge_tids(tids_i, cnt_i, tids_j, lmax):
    """Concatenate two leaf-cluster id lists into one (l, lmax) list:
    slot s takes tids_i[s] while s < cnt_i, else tids_j[s - cnt_i]
    (caller guarantees the combined count fits lmax)."""
    out = []
    for s in range(lmax):
        v = jnp.full(tids_i.shape[0], -1, jnp.int32)
        for t in range(min(s + 1, lmax)):
            # v = tids_j[s - cnt_i] when cnt_i == s - t... unrolled pick
            v = jnp.where(cnt_i == (s - t), tids_j[:, t], v)
        out.append(jnp.where(s < cnt_i, tids_i[:, s], v))
    return jnp.stack(out, axis=1)


def _ploc_merge(cmin0, cmax0, tids0, m0, l, lmax, radius):
    """The PLOC loop: merge mutual nearest neighbors until one cluster.

    Clusters are position-ordered (Morton order of their seed
    triangle); a cluster is either a LEAF-CLUSTER (<= lmax sorted-slot
    ids in ``tids``, no node allocated) or a NODE (materialized
    subtree).  Returns per-merge internal records in creation order k
    (children encoded: leaf row j -> (l-1)+j, internal k' -> -(k'+1)),
    the leaf-row tables, and the box of every internal and row."""
    pos = jnp.arange(l, dtype=jnp.int32)

    def cost_with(cmin, cmax, o, m):
        """(l,) union half-area of (p, p+o); inf when p+o >= m."""
        nb_min = jnp.concatenate([cmin[o:], jnp.full((o, 3), _BIG)])
        nb_max = jnp.concatenate([cmax[o:], jnp.full((o, 3), -_BIG)])
        a = _half_area(jnp.minimum(cmin, nb_min),
                       jnp.maximum(cmax, nb_max))
        return jnp.where(pos + o < m, a, _BIG)

    def cond(st):
        m = st["m"]
        return jnp.logical_and(m > 1,
                               st["it"] < 4 * int(np.log2(max(l, 2)))
                               + 192)

    def body(st):
        m, it = st["m"], st["it"]
        cmin, cmax, cnt, tids = (st["cmin"], st["cmax"], st["cnt"],
                                 st["tids"])
        nid = st["nid"]          # internal creation idx; -1 = leaf-cluster
        # ---- windowed pair costs ----
        costs = [cost_with(cmin, cmax, o, m) for o in range(1, radius + 1)]
        f_cost = jnp.full(l, _BIG)
        f_off = jnp.zeros(l, jnp.int32)
        for o in range(1, radius + 1):
            better = costs[o - 1] < f_cost
            f_cost = jnp.where(better, costs[o - 1], f_cost)
            f_off = jnp.where(better, o, f_off)
        b_cost = jnp.full(l, _BIG)
        b_off = jnp.zeros(l, jnp.int32)
        for o in range(1, radius + 1):
            shifted = jnp.concatenate([jnp.full(o, _BIG),
                                       costs[o - 1][:-o]])
            better = shifted < b_cost
            b_cost = jnp.where(better, shifted, b_cost)
            b_off = jnp.where(better, o, b_off)
        use_b = b_cost < f_cost
        nn = jnp.clip(jnp.where(use_b, pos - b_off, pos + f_off), 0, l - 1)
        alive = pos < m
        mutual = alive & alive[nn] & (nn[nn] == pos)
        mg_nn = mutual & (nn > pos)
        ab_nn = mutual & (nn < pos)
        # progress guarantee: past a soft iteration cap, or on a no-merge
        # round (cost ties), halve by even/odd neighbors instead
        use_fb = (it >= 128) | ~mg_nn.any()
        mg = jnp.where(use_fb, (pos % 2 == 0) & (pos + 1 < m), mg_nn)
        absorbed = jnp.where(use_fb, (pos % 2 == 1) & (pos < m), ab_nn)
        nn = jnp.where(use_fb, jnp.minimum(pos + 1, l - 1), nn)

        j = jnp.where(mg, nn, pos)
        u_min = jnp.minimum(cmin, cmin[j])
        u_max = jnp.maximum(cmax, cmax[j])
        u_cnt = cnt + jnp.where(mg, cnt[j], 0)
        i_leaf = nid < 0
        j_leaf = i_leaf[j]
        stay_leaf = mg & i_leaf & j_leaf & (u_cnt <= lmax)
        make_int = mg & ~stay_leaf

        # ---- leaf-row materialization for internal-creating merges ----
        need_i = make_int & i_leaf
        need_j = make_int & j_leaf
        n_rows = (need_i.astype(jnp.int32) + need_j.astype(jnp.int32))
        r_base = st["k_leaf"] + jnp.cumsum(n_rows) - n_rows
        row_i = r_base
        row_j = r_base + need_i.astype(jnp.int32)
        rt, rc = st["row_tids"], st["row_cnt"]
        rt = rt.at[jnp.where(need_i, row_i, l)].set(tids, mode="drop")
        rc = rc.at[jnp.where(need_i, row_i, l)].set(cnt, mode="drop")
        rt = rt.at[jnp.where(need_j, row_j, l)].set(tids[j], mode="drop")
        rc = rc.at[jnp.where(need_j, row_j, l)].set(cnt[j], mode="drop")

        # ---- internal allocation ----
        ni = make_int.astype(jnp.int32)
        k_slot = st["k_int"] + jnp.cumsum(ni) - ni
        child_i = jnp.where(i_leaf, (l - 1) + row_i, -(nid + 1))
        child_j = jnp.where(j_leaf, (l - 1) + row_j, -(nid[j] + 1))
        tgt = jnp.where(make_int, k_slot, l - 1)
        lk = st["lk"].at[tgt].set(jnp.where(make_int, child_i, 0),
                                  mode="drop")
        rk = st["rk"].at[tgt].set(jnp.where(make_int, child_j, 0),
                                  mode="drop")
        lvl = st["lvl"].at[tgt].set(jnp.where(make_int, it, 0),
                                    mode="drop")
        bmn = st["bmn"].at[tgt].set(jnp.where(make_int[:, None], u_min,
                                              0.0), mode="drop")
        bmx = st["bmx"].at[tgt].set(jnp.where(make_int[:, None], u_max,
                                              0.0), mode="drop")

        # ---- update merged clusters in place (lower position) ----
        cmin = jnp.where(mg[:, None], u_min, cmin)
        cmax = jnp.where(mg[:, None], u_max, cmax)
        cnt = jnp.where(mg, u_cnt, cnt)
        tids = jnp.where(stay_leaf[:, None],
                         _merge_tids(tids, st["cnt"], tids[j], lmax),
                         tids)
        nid = jnp.where(make_int, k_slot, nid)

        # ---- compact: alive-first, stable ----
        dead = absorbed | ~alive
        perm = jnp.argsort(dead.astype(jnp.int32), stable=True)
        return dict(
            m=m - mg.sum(dtype=jnp.int32), it=it + 1,
            k_int=st["k_int"] + ni.sum(),
            k_leaf=st["k_leaf"] + n_rows.sum(),
            cmin=cmin[perm], cmax=cmax[perm], cnt=cnt[perm],
            tids=tids[perm], nid=nid[perm],
            lk=lk, rk=rk, lvl=lvl, bmn=bmn, bmx=bmx,
            row_tids=rt, row_cnt=rc)

    zi = jnp.zeros(l - 1, jnp.int32)
    z3 = jnp.zeros((l - 1, 3), jnp.float32)
    st = dict(
        m=m0, it=jnp.int32(0), k_int=jnp.int32(0), k_leaf=jnp.int32(0),
        cmin=cmin0, cmax=cmax0,
        cnt=jnp.ones(l, jnp.int32), tids=tids0,
        nid=jnp.full(l, -1, jnp.int32),
        lk=zi, rk=zi, lvl=zi, bmn=z3, bmx=z3,
        row_tids=jnp.full((l, lmax), -1, jnp.int32),
        row_cnt=jnp.zeros(l, jnp.int32))
    st = jax.lax.while_loop(cond, body, st)
    return (st["lk"], st["rk"], st["lvl"], st["bmn"], st["bmx"],
            st["row_tids"], st["row_cnt"], st["k_int"], st["it"])


def _collapse_ploc(lchild, rchild, n_int, l, width):
    """Depth-stride wide collapse of the PLOC binary tree (the
    above-cut half of lbvh._collapse_wide, over a tree whose leaves ARE
    the wide leaf rows: old ids — internals 0..n_int-1 (root 0), leaf
    row j at (l-1)+j; internal ids >= n_int are dead padding)."""
    n_nodes = 2 * l - 1
    i_idx = jnp.arange(l - 1, dtype=jnp.int32)
    vi = i_idx < n_int
    parent = jnp.zeros(n_nodes, jnp.int32)
    parent = parent.at[jnp.where(vi, lchild, n_nodes)].set(i_idx,
                                                           mode="drop")
    parent = parent.at[jnp.where(vi, rchild, n_nodes)].set(i_idx,
                                                           mode="drop")

    depth = jnp.zeros(l - 1, jnp.int32)
    ready = (i_idx == 0) & vi

    def body(c):
        depth, it, ready = c
        p = jnp.clip(parent[: l - 1], 0, l - 2)
        can = vi & ready[p] & ~ready & (i_idx != 0)
        depth = jnp.where(can, depth[p] + 1, depth)
        return depth, it + 1, ready | can

    depth, _, _ = jax.lax.while_loop(
        lambda c: jnp.logical_and(jnp.any((~c[2]) & vi), c[1] < 256),
        body, (depth, jnp.int32(0), ready))

    stride = 2 if width == 4 else 3
    surv = vi & ((depth % stride) == 0)

    is_leaf_l = lchild >= l - 1
    is_leaf_r = rchild >= l - 1
    lc_s = jnp.clip(lchild, 0, l - 2)
    rc_s = jnp.clip(rchild, 0, l - 2)
    a_left = jnp.where(is_leaf_l, 1, 2)
    a_right = jnp.where(is_leaf_r, 1, 2)
    arity4 = a_left + a_right

    left0 = jnp.where(is_leaf_l, lchild, lchild[lc_s])
    left1 = jnp.where(is_leaf_l, -1, rchild[lc_s])
    right0 = jnp.where(is_leaf_r, rchild, lchild[rc_s])
    right1 = jnp.where(is_leaf_r, -1, rchild[rc_s])

    def slot4(t):
        in_left = t < a_left
        li = jnp.where(t == 0, left0, left1)
        u = t - a_left
        ri = jnp.where(u == 0, right0, jnp.where(u == 1, right1, -1))
        return jnp.where(in_left, li, jnp.where(t < arity4, ri, -1))

    ch4 = jnp.stack([slot4(jnp.full(l - 1, t, jnp.int32))
                     for t in range(4)], axis=1)

    if width == 4:
        ch_old, arity = ch4, arity4
    else:
        a_l8 = jnp.where(is_leaf_l, 1, arity4[lc_s])
        a_r8 = jnp.where(is_leaf_r, 1, arity4[rc_s])
        arity = a_l8 + a_r8
        ch4_l = ch4[lc_s]
        ch4_r = ch4[rc_s]

        def sel4(mtx, t):
            tc = jnp.clip(t, 0, 3)
            r = mtx[:, 0]
            for i in (1, 2, 3):
                r = jnp.where(tc == i, mtx[:, i], r)
            return r

        def slot8(t):
            lt = jnp.where(is_leaf_l,
                           jnp.where(t == 0, lchild, -1), sel4(ch4_l, t))
            u = t - a_l8
            rt = jnp.where(is_leaf_r,
                           jnp.where(u == 0, rchild, -1), sel4(ch4_r, u))
            return jnp.where(t < a_l8, lt, jnp.where(t < arity, rt, -1))

        ch_old = jnp.stack([slot8(jnp.full(l - 1, t, jnp.int32))
                            for t in range(8)], axis=1)

    contrib = jnp.where(surv, arity, 0)
    base = 1 + jnp.cumsum(contrib) - contrib
    newid = jnp.full(n_nodes, -1, jnp.int32).at[0].set(0)
    for t in range(width):
        idx = ch_old[:, t]
        val = base + t
        ok = surv & (idx >= 0)
        newid = newid.at[jnp.where(ok, idx, n_nodes)].set(
            jnp.where(ok, val, 0), mode="drop")
    return surv, ch_old, arity, base, newid


def _row_boxes(v0, v1, v2, order, row_tids, row_cnt):
    """(l, 3) min/max box per leaf row from its explicit sorted-slot
    ids (unused rows get an inverted box that never wins a union)."""
    t = v0.shape[0]
    # packed (T, 6) box rows: one gather per indirection instead of two
    # (descriptor count prices the gather — ARCHITECTURE rule 36)
    box6 = jnp.concatenate(
        [jnp.minimum(jnp.minimum(v0, v1), v2),
         jnp.maximum(jnp.maximum(v0, v1), v2)], axis=1)[order]
    lmax = row_tids.shape[1]
    k = jnp.arange(lmax, dtype=jnp.int32)
    valid = k[None, :] < row_cnt[:, None]
    idx = jnp.clip(row_tids, 0, t - 1)
    sbox = box6[idx]                               # (l, lmax, 6)
    bmin = jnp.where(valid[..., None], sbox[..., 0:3], _BIG).min(1)
    bmax = jnp.where(valid[..., None], sbox[..., 3:6], -_BIG).max(1)
    return bmin, bmax


def _rows_from_tids(v0, v1, v2, order, row_tids, row_cnt):
    """(l, 16*lmax) packed leaf rows from explicit sorted-slot ids —
    the non-contiguous generalization of lbvh._leaf_rows (PLOC leaves
    are arbitrary triangle sets, not Morton ranges)."""
    t = v0.shape[0]
    lmax = row_tids.shape[1]
    k = jnp.arange(lmax, dtype=jnp.int32)
    valid = k[None, :] < row_cnt[:, None]
    slot = jnp.clip(row_tids, 0, t - 1)
    tid = order[slot]                       # global tri ids
    # one (T, 9) row gather instead of three (T, 3) (rule 36)
    v9 = jnp.concatenate([v0, v1, v2], axis=1)[tid]
    sv0 = v9[..., 0:3]
    se1 = v9[..., 3:6] - sv0
    se2 = v9[..., 6:9] - sv0
    zero = ~valid[..., None]
    sv0 = jnp.where(zero, 0.0, sv0)
    se1 = jnp.where(zero, 0.0, se1)
    se2 = jnp.where(zero, 0.0, se2)
    tids_f = jax.lax.bitcast_convert_type(
        jnp.where(valid, tid, -1), jnp.float32)
    rows = jnp.zeros((row_tids.shape[0], 16 * lmax), jnp.float32)
    for c in range(lmax):
        rows = rows.at[:, 16 * c: 16 * c + 3].set(sv0[:, c])
        rows = rows.at[:, 16 * c + 3: 16 * c + 6].set(se1[:, c])
        rows = rows.at[:, 16 * c + 6: 16 * c + 9].set(se2[:, c])
        rows = rows.at[:, 16 * c + 9].set(tids_f[:, c])
    return rows


@partial(jax.jit, static_argnames=("leaf_size", "width", "radius"))
def build_ploc_topo(v0, v1, v2, leaf_size: int = 4, width: int = 4,
                    radius: int = 16):
    """Device PLOC build -> (LBVHNodes, PLOCTopo).

    Morton sort seeds the neighbor window only; every split AND every
    leaf is chosen by the clustering."""
    t = v0.shape[0]
    l = t
    assert l > leaf_size, "scene smaller than one leaf"

    tmin = jnp.minimum(jnp.minimum(v0, v1), v2)
    tmax = jnp.maximum(jnp.maximum(v0, v1), v2)
    cen = (v0 + v1 + v2) / 3.0
    smin, smax = tmin.min(0), tmax.max(0)
    ext = jnp.maximum(smax - smin, 1e-30)
    nrm = (cen - smin) / ext
    codes = morton3d(nrm[:, 0], nrm[:, 1], nrm[:, 2])
    order = jnp.argsort(codes, stable=True).astype(jnp.int32)

    # initial clusters = triangles in Morton order; tids hold SORTED
    # SLOTS (0..l-1) so refit can re-gather moved vertices via `order`
    tids0 = jnp.full((l, leaf_size), -1, jnp.int32)
    tids0 = tids0.at[:, 0].set(jnp.arange(l, dtype=jnp.int32))
    (lk, rk, lvl, bmn, bmx, row_tids, row_cnt, n_int,
     n_lvls) = _ploc_merge(tmin[order], tmax[order], tids0,
                           jnp.int32(l), l, leaf_size, radius)

    # remap creation order k -> packer old ids (root = internal 0):
    # old = n_int-1-k; encoded children -(k+1) -> n_int + enc
    kk = jnp.arange(l - 1, dtype=jnp.int32)
    tgt = jnp.where(kk < n_int, n_int - 1 - kk, l - 1)

    def remap(c):
        return jnp.where(c >= l - 1, c, n_int + c)

    zi = jnp.zeros(l - 1, jnp.int32)
    lchild = zi.at[tgt].set(remap(lk), mode="drop")
    rchild = zi.at[tgt].set(remap(rk), mode="drop")
    level = zi.at[tgt].set(lvl, mode="drop")
    imin = jnp.zeros((l - 1, 3), jnp.float32).at[tgt].set(bmn, mode="drop")
    imax = jnp.zeros((l - 1, 3), jnp.float32).at[tgt].set(bmx, mode="drop")

    surv, ch_old, arity, base, newid = _collapse_ploc(
        lchild, rchild, n_int, l, width)
    zi_l = jnp.zeros(l, jnp.int32)
    topo = LBVHTopo(order=order, lchild=lchild, rchild=rchild, surv=surv,
                    ch_old=ch_old, arity=arity, base=base, newid=newid,
                    row_lo=zi_l, row_cnt=row_cnt,
                    leaf_newid=newid[l - 1:], lo=zi_l[: l - 1],
                    hi=zi_l[: l - 1])
    ptopo = PLOCTopo(topo=topo, leaf_tids=row_tids, level=level,
                     n_int=n_int, n_levels=n_lvls)
    cmin, cmax = _row_boxes(v0, v1, v2, order, row_tids, row_cnt)
    blas = _pack_wide(topo, jnp.concatenate([imin, cmin]),
                      jnp.concatenate([imax, cmax]), l, leaf_size,
                      root_offset=0, width=width)
    rows = _rows_from_tids(v0, v1, v2, order, row_tids, row_cnt)
    nodes = LBVHNodes(nodes=blas, tri_rows=rows,
                      num_leaves=(row_cnt > 0).sum())
    return nodes, ptopo


@partial(jax.jit, static_argnames=("leaf_size", "width"))
def refit_ploc(ptopo: PLOCTopo, v0, v1, v2, leaf_size: int = 4,
               width: int = 4) -> LBVHNodes:
    """Refit-only fast path for a PLOC topology (config-5 animation):
    leaf boxes reduce over the explicit per-row ids; internal boxes
    sweep bottom-up BY CREATION LEVEL (a topological order — children
    are created in strictly earlier PLOC iterations)."""
    t = v0.shape[0]
    l = t
    topo = ptopo.topo
    cmin, cmax = _row_boxes(v0, v1, v2, topo.order, ptopo.leaf_tids,
                            topo.row_cnt)

    i_idx = jnp.arange(l - 1, dtype=jnp.int32)
    vi = i_idx < ptopo.n_int
    imin = jnp.zeros((l - 1, 3), jnp.float32)
    imax = jnp.zeros((l - 1, 3), jnp.float32)

    def child_box(c, imn, imx):
        leaf = c >= l - 1
        ci = jnp.clip(c - (l - 1), 0, l - 1)
        cc = jnp.clip(c, 0, l - 2)
        mn = jnp.where(leaf[:, None], cmin[ci], imn[cc])
        mx = jnp.where(leaf[:, None], cmax[ci], imx[cc])
        return mn, mx

    def body(c):
        lev, imn, imx = c
        # levels run bottom-up: process creation level n_levels-1-lev?
        # No — children have strictly SMALLER creation level, so
        # ascending level order IS bottom-up.
        at = vi & (ptopo.level == lev)
        lmn, lmx = child_box(topo.lchild, imn, imx)
        rmn, rmx = child_box(topo.rchild, imn, imx)
        imn = jnp.where(at[:, None], jnp.minimum(lmn, rmn), imn)
        imx = jnp.where(at[:, None], jnp.maximum(lmx, rmx), imx)
        return lev + 1, imn, imx

    _, imin, imax = jax.lax.while_loop(
        lambda c: c[0] < ptopo.n_levels, body,
        (jnp.int32(0), imin, imax))

    blas = _pack_wide(topo, jnp.concatenate([imin, cmin]),
                      jnp.concatenate([imax, cmax]), l, leaf_size,
                      root_offset=0, width=width)
    rows = _rows_from_tids(v0, v1, v2, topo.order, ptopo.leaf_tids,
                           topo.row_cnt)
    return LBVHNodes(nodes=blas, tri_rows=rows,
                     num_leaves=(topo.row_cnt > 0).sum())


def build_wide_ploc(sb, leaf_size: int = 4, width: int = 4,
                    radius: int = 16):
    """Scene -> traversal-ready WideArrays via the on-device PLOC build
    (the quality path of BASELINE config 3; same contract as
    lbvh.build_wide_from_tris)."""
    from vortex_rt_tpu.accel.lbvh import wide_arrays_from_lbvh

    assert sb.inst_transform.shape[0] == 1 and np.allclose(
        sb.inst_transform[0], np.eye(4)), \
        "LBVH direct build needs a single identity instance"
    v0, v1, v2 = pad_tris(sb.v0, sb.v1, sb.v2, leaf_size)
    lb, _ = build_ploc_topo(jnp.asarray(v0), jnp.asarray(v1),
                            jnp.asarray(v2), leaf_size=leaf_size,
                            width=width, radius=radius)
    return wide_arrays_from_lbvh(lb, leaf_size, width=width)
