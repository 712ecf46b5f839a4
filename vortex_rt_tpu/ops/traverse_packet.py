"""Packet traversal: one shared node walk per coherent ray packet.

The per-ray engine (ops.traverse_wide) pays one record gather per ray per
step.  This engine removes that cost with the classic SIMD packet
transform (Wald-style ray packets, re-shaped as array programs):

* rays are grouped into packets of P (consecutive pool lanes — pixel-major
  order makes primary packets spatially coherent);
* ONE traversal state per packet: node / level / restart trail / short
  stack are (B,) lanes (B = R/P packets), so the node record gather runs
  over B rows instead of R — at B = R/64 the gather+extract cost collapses
  to noise and per-field values broadcast to (B, 1) against (B, P) ray
  lanes for the vector tests;
* a child is visited iff ANY live ray in the packet hits its slab
  strictly closer than that ray's own best hit.  This per-ray-pruned
  visit set is time-varying, which is UNSOUND combined with trail
  restarts (the trail counts "k closest visited" against an order that
  would have shifted by the revisit).  The per-packet stack is
  therefore statically sized to the worst case (one word per tree
  level, see below): overflow cannot occur, restarts never happen,
  every node is entered exactly once, and pruning is sound.  With
  restarts impossible the reference's restart trail
  (rt_traversal.cpp:170-213) is dead machinery and is NOT carried —
  the plain stack DFS visits the identical node sequence;
* the stack packs each node's <=3 deferred children into ONE i32 word
  (left_first << 8 | count << 6 | sorted slot ids in 3x2 bits), so a
  descend costs one shift-register push of ~depth words instead of
  three pushes of 3*depth entries, and 2 of every 3 pops rewrite the
  top word in place (count-1, nearest-first order preserved).  The XLA
  while_loop body is bound by op COUNT, not FLOPs (each op on small
  (B,)/(B,P) operands pays a fixed dispatch/relayout cost), so stack +
  trail ops were the single largest line item of the old body;
* the WIDTH child slab tests and the per-leaf Moller-Trumbore tests
  run as single (WIDTH,B,P)/(L,B,P) batched ops (one op chain over the
  stacked axis instead of WIDTH/L unrolled chains) for the same
  op-count reason;
* leaves run Moller-Trumbore for every ray in the packet against the
  leaf's triangles (same packed leaf rows as the per-ray engine).

The cost trade: the packet walks the UNION of its rays' paths (coherent
primary packets visit ~1.2-2x the nodes of one ray; incoherent bounce
packets more), but every step's memory traffic is divided by P.  Results
are bit-compatible with the per-ray engine's auto-accept mode (same
intersection math, same lexicographic (t, instance, tri) tie-break).

Any-hit SUSPENSION is not supported here (packets cannot pause per-ray)
— but the alpha-test any-hit doesn't need suspension: it is a pure
per-candidate predicate, so ``alpha_ref`` evaluates it INSIDE the
traversal loop (see trace_packets docstring).  The wavefront engine uses
this path for no-any-hit pipelines (the reference's shipped always-accept
shader) AND for alpha-test any-hit tables; only custom stateful any-hit
shaders fall back to the per-ray suspension engine.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vortex_rt_tpu.accel import qbvh
from vortex_rt_tpu.ops.traverse2 import Hits
from vortex_rt_tpu.ops.traverse_wide import (
    WIDTH, WideArrays, _INT_MAX, _LEFT_BITS, _LEFT_BITS8, _LEFT_MASK,
    _MISS, _ROW_WORDS, _at_pos, _bitcast_f32, _bitcast_i32,
    _meta_bits_for, _rcp_lane, _row_layout,
)

# lax.sort child ordering instead of the explicit network (sweepable:
# the loop body is op-count-bound, so 19 comparators x ~6 small ops at
# width 8 vs one fused variadic sort is a measurable trade either way)
_LAX_SORT_DEFAULT = __import__("os").environ.get(
    "VORTEX_RT_LAX_SORT", "0") == "1"

# descending sorting networks (far -> near) over the child-slot lanes;
# comparator counts are optimal (5 for 4 inputs, 19 for 8 — Knuth 5.3.4);
# 16 inputs use Batcher odd-even merge (63 comparators, correct by
# construction — within 5% of the best known 60)
def _batcher_pairs(n):
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(0, min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return tuple(pairs)


_SORT_NET = {
    4: ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)),
    8: ((0, 2), (1, 3), (4, 6), (5, 7), (0, 4), (1, 5), (2, 6), (3, 7),
        (0, 1), (2, 3), (4, 5), (6, 7), (2, 4), (3, 5), (1, 4), (3, 6),
        (1, 2), (3, 4), (5, 6)),
    16: _batcher_pairs(16),
}


def _stack_push_n(st, count, entry, mask):
    """Shift-register push over an n-tuple of (B,) lanes."""
    ns = [jnp.where(mask, entry, st[0])]
    for i in range(1, len(st)):
        ns.append(jnp.where(mask, st[i - 1], st[i]))
    return tuple(ns), jnp.where(mask, count + 1, count)


def _stack_pop_n(st, count, mask):
    entry = st[0]
    ns = []
    for i in range(len(st) - 1):
        ns.append(jnp.where(mask, st[i + 1], st[i]))
    ns.append(jnp.where(mask, jnp.zeros_like(st[-1]), st[-1]))
    return entry, tuple(ns), jnp.where(mask, count - 1, count)


# (B, S) array-stack variants (VORTEX_RT_ARRAY_STACK): the whole shift
# register moves in ONE concat + ONE where instead of S per-level ops —
# an op-count play for the op-count-bound loop body.  Packet-major
# layout keeps compaction's generic row gather (state[k][keep]) correct.
def _stack_push_a(st, count, entry, mask):
    ns = jnp.where(mask[:, None],
                   jnp.concatenate([entry[:, None], st[:, :-1]], axis=1),
                   st)
    return ns, jnp.where(mask, count + 1, count)


def _stack_pop_a(st, count, mask):
    entry = st[:, 0]
    shifted = jnp.concatenate([st[:, 1:], jnp.zeros_like(st[:, :1])],
                              axis=1)
    ns = jnp.where(mask[:, None], shifted, st)
    return entry, ns, jnp.where(mask, count - 1, count)


_ARRAY_STACK_DEFAULT = __import__("os").environ.get(
    "VORTEX_RT_ARRAY_STACK", "0") == "1"

# while-body unroll factor (sweepable): k sub-steps per while iteration
# trade k-fold fewer fixed per-iteration overheads against a k-fold
# larger body (rule 27).  Bit-identical: a sub-step on a done packet is
# the identity on every field but the step counter
_UNROLL_DEFAULT = int(__import__("os").environ.get(
    "VORTEX_RT_UNROLL", "1"))

# straggler-compaction round-shrink factor (see the compaction driver
# below): 4 = round widths B/4, B/16, ...; 2 = B/2, B/4, B/8, ...
_COMPACT_DIV_DEFAULT = max(int(__import__("os").environ.get(
    "VORTEX_RT_COMPACT_DIV", "4")), 2)

# conservative bfloat16 child slab test (VORTEX_RT_BF16_SLAB): the slab
# arithmetic is a large, memory-shaped part of the loop body (rule 39)
# — bf16 halves its bytes.
# Soundness: the test runs in NODE-LOCAL coordinates (ray origin minus
# node origin, subtracted in f32 per packet — this kills the
# catastrophic-cancellation hazard of bf16-ing world coordinates), box
# corners q*2^e are EXACT bf16 products (q <= 256 fits the 8-bit
# significand, scale is a power of two), boxes are widened by +-1
# quantization LSB (an ABSOLUTE pad covering the one rounding of the
# local subtraction near the node) and tmin/tmax get a 2^-6 RELATIVE
# pad (covering the multiply/cast roundings, error <= ~5*2^-8 of the
# value).  The visit set becomes a strict SUPERSET of the f32 walk's,
# so the closest hit is BIT-IDENTICAL (Moller-Trumbore stays f32);
# only step counts change.  Same argument as the build-time outward
# quantization (accel.qbvh) — the box was never exact to begin with.
_BF16_SLAB_DEFAULT = __import__("os").environ.get(
    "VORTEX_RT_BF16_SLAB", "0") == "1"
from vortex_rt_tpu.utils.config import LARGE_FLOAT, MT_EPSILON


class PacketStats(NamedTuple):
    """RTU PerfStats analog (sim/simx/rt_unit.h:15-45 latency/SIMT
    accounting, dormant in the reference): per-trace divergence and
    occupancy aggregates, all cheap scalar reductions carried in the
    traversal loop (enable with ``stats=True``).

    occupancy  = packet_steps / (steps * B): fraction of packets still
                 walking per iteration (persistent-lane headroom metric)
    lane_util  = lane-steps in live packets / packet-steps / P would need
                 per-ray liveness; we report live-packet lane counts
                 (rays that can still improve their hit) as ray_steps
    kind mix   = how many packet-steps landed on internal / triangle /
                 instance nodes (memory-shape of the walk)
    """

    steps: jnp.ndarray          # loop iterations
    packet_steps: jnp.ndarray   # sum over steps of live packets
    ray_steps: jnp.ndarray      # sum over steps of live rays in live packets
    int_steps: jnp.ndarray      # packet-steps at internal nodes
    tri_steps: jnp.ndarray      # packet-steps at triangle leaves
    ins_steps: jnp.ndarray      # packet-steps at instance leaves


def trace_packets(
    wa: WideArrays,
    o: jnp.ndarray,
    d: jnp.ndarray,
    packet: int = 64,
    active: Optional[jnp.ndarray] = None,
    max_steps: int = 400_000,
    t_max: Optional[jnp.ndarray] = None,
    occlusion: bool = False,
    occl_split: int = 0,
    stats: bool = False,
    lax_sort: Optional[bool] = None,
    array_stack: Optional[bool] = None,
    unroll: Optional[int] = None,
    alpha_ref: Optional[float] = None,
    anyhit_pred=None,
    fronts: int = 1,
    bf16_slab: Optional[bool] = None,
) -> Tuple[Hits, jnp.ndarray]:
    """Closest-hit trace of (R, 3) rays in packets of ``packet`` lanes.

    R must be a multiple of ``packet``.  ``active`` masks dead pool lanes
    (their results stay at miss).  Returns (Hits, total steps).

    ``t_max`` (R,) clamps each ray's search interval.  ``occlusion=True``
    turns the trace into a bounded any-hit occlusion query (the shadow-ray
    mode, rt_unit.cpp:190-213 ACCEPT-and-stop semantics): the FIRST hit
    with t < t_max retires the ray (no closest-hit search), occluded rays
    stop contributing to the packet's visit union, and a packet whose live
    rays are all occluded exits.  Occluded rays return dist=0.0 (< t_max);
    unoccluded rays return dist=LARGE_FLOAT.  Barycentrics/tri ids are
    meaningless in this mode.

    ``occl_split=k`` (static, multiple of ``packet``) runs a MIXED wave:
    the first k rays trace in occlusion mode, the rest closest-hit — one
    while_loop covers both, so a shadow wave and the next bounce wave
    overlap their straggler tails (the wavefront engine's merged wave).
    Packets are homogeneous (k is packet-aligned), so the mode is a
    per-packet flag that survives compaction.

    ``stats=True`` additionally carries PacketStats scalar aggregates in
    the loop and returns (Hits, PacketStats) instead of (Hits, steps).

    ``alpha_ref`` enables the IN-LOOP alpha-test any-hit (requires
    ``wa.with_alpha`` tables): every Moller-Trumbore candidate whose
    surface alpha (luminance of the point-sampled texel, or of the
    material diffuse when untextured — exactly what alpha_test_anyhit
    computes through the suspension protocol) is below ``alpha_ref`` is
    rejected before the closest-hit fold, i.e. COMMIT_CONT without
    per-ray suspension (rt_unit.cpp:190-213; shaders/anyhit.cpp is the
    stub this implements for real).  Alpha rejection is a pure
    per-candidate predicate, so evaluating it inside the loop visits
    the identical accepted-hit set as the per-ray suspension engine.

    ``anyhit_pred`` generalizes alpha_ref to ANY stateless per-candidate
    predicate: a traced callable ``pred(u, v, alpha) -> keep`` over the
    candidate's interpolated uv and surface alpha (the luminance
    shade_point would compute there — point-sampled texel or material
    diffuse), applied to every Moller-Trumbore candidate before the
    closest-hit fold.  keep=False is COMMIT_CONT, keep=True lets the
    candidate into the fold (ACCEPT when it wins).  This is the packet-
    speed analog of the reference's arbitrary any-hit shader binaries
    (shaders/anyhit.cpp entry + rt_unit.cpp:190-213 CONT/ACCEPT) for
    the stateless subset; shaders that mutate per-ray payload state
    still need the per-ray suspension engine.  Requires
    ``wa.with_alpha`` tables (they carry uv + the alpha texel pool).
    When both are given, anyhit_pred wins; alpha_ref is exactly
    ``anyhit_pred=lambda u, v, a: ~(a < alpha_ref)``.

    ``fronts=F`` (flat builds only) walks F stack nodes per packet per
    iteration: ONE (F*B,)-row gather + F-axis-batched slab/MT tests
    halve(+) the iteration count of incoherent waves whose per-iteration
    cost is gather-latency-bound: two node rows fetched in ONE gather
    instead of two chained ones (ARCHITECTURE.md rule 32).  The fronts drain
    one SHARED per-packet stack, so together they run the same DFS; hits
    are bit-identical (each ray's result is a min-fold over its own
    intersecting candidates with the exact lexicographic tie-break —
    visit ORDER changes, the candidate winner cannot; same argument as
    packet-size/compaction bit-compatibility).  Exact-tie caveat (this
    applies to the packet-size/compaction identity argument too): node
    pruning uses strict tmin < best_t, so if a box's dequantized entry
    tmin EXACTLY equals a ray's current best t, a leaf holding an
    equal-t lower-id triangle could be pruned under one visit order and
    visited under another, flipping the lexicographic tie winner.  The
    quantized child bounds are dequantized OUTWARD (lo floor / hi ceil
    at build), so a triangle lying exactly on its leaf's entry plane
    with t == tmin requires an exact-float coincidence across two
    different computations (slab arithmetic vs Moller-Trumbore) —
    never observed; tests/test_fronts.py pins bit-identity on every
    shipped mode.  Falls back to 1 front on TLAS builds (per-front
    local-space lanes would re-inflate the loop state flattening
    removed)."""
    r = o.shape[0]
    p = int(packet)
    assert r % p == 0, "ray count must be a multiple of the packet size"
    b = r // p
    if occlusion:
        occl_split = r
    occl_split = int(occl_split)
    assert 0 <= occl_split <= r and occl_split % p == 0
    mixed = 0 < occl_split < r
    occlusion = occl_split == r
    # flattened-scene fast path (WideArrays.tri_bits): no TLAS/instance
    # nodes exist, so the loop drops the 9 local-space lanes + inst
    # state entirely (~40% of per-ray loop bytes) and the instance
    # branch; leaf tids arrive packed (inst << tri_bits) | tri, whose
    # i32 compare IS the (inst, tri) lexicographic tie-break
    if lax_sort is None:
        lax_sort = _LAX_SORT_DEFAULT
    if array_stack is None:
        array_stack = _ARRAY_STACK_DEFAULT
    if unroll is None:
        unroll = _UNROLL_DEFAULT
    unroll = max(int(unroll), 1)
    if bf16_slab is None:
        bf16_slab = _BF16_SLAB_DEFAULT
    bf16_slab = bool(bf16_slab)  # frame-agnostic: node-local coords
    flat = wa.num_tlas == 0 and wa.tri_bits > 0
    fronts = max(int(fronts), 1) if flat else 1
    if anyhit_pred is None and alpha_ref is not None:
        _ar = jnp.float32(alpha_ref)

        def anyhit_pred(u, v, a, _ar=_ar):  # noqa: ARG001
            return ~(a < _ar)
    assert anyhit_pred is None or wa.alpha_rows is not None, \
        "anyhit_pred/alpha_ref require WideArrays.with_alpha tables"
    n_pool = int(wa.nodes.shape[0])
    w_ = int(wa.width)
    assert w_ == 4 or flat, "8/16-wide packets require the flattened build"
    qoff, hoff, moff, loff, _ = _row_layout(w_)
    nrow = _ROW_WORDS[w_]
    lbits, nmask = _meta_bits_for(w_)
    lmask = (1 << lbits) - 1
    # packed-stack word layouts:
    #   width 4:  ONE word    = left << 8 | count << 6 | 3x2b sorted slots
    #   width 8:  TWO words   = (left << 4 | count, 7x3b sorted slots) —
    #             7 deferred slots don't fit beside left in one i32
    #   width 16: THREE words = (left << 4 | count, slots 0..7 x4b,
    #             slots 8..14 x4b)
    assert n_pool < (1 << {4: 23, 8: 26, 16: 24}[w_]), \
        "node pool exceeds packed-stack id budget"
    n_leaf_rows = int(wa.tri_rows.shape[0])
    lmax = max(int(wa.max_leaf_tris), 1)
    # fused rows carrying the alpha-test fields (with_alpha after fuse):
    # the any-hit leaf step then reads uv/texture-window fields from the
    # SAME gathered row instead of a second same-depth gather
    fused_alpha = (wa.fused is not None
                   and int(wa.fused.shape[1]) >= nrow + 24 * lmax)
    eps = jnp.float32(MT_EPSILON)
    # overflow-proof stack: one deferred-children word per descended
    # level (x fronts: each concurrent front can hold its own descend
    # chain's words on the shared stack)
    stack_n = (int(wa.depth) + 4) * fronts

    def l2(x):  # (R,) -> (B, P)
        return x.reshape(b, p)

    ox, oy, oz = l2(o[:, 0]), l2(o[:, 1]), l2(o[:, 2])
    dx, dy, dz = l2(d[:, 0]), l2(d[:, 1]), l2(d[:, 2])
    ivx, ivy, ivz = _rcp_lane(dx), _rcp_lane(dy), _rcp_lane(dz)
    ray_on = (jnp.ones((b, p), bool) if active is None
              else l2(active))
    limit = (jnp.full((b, p), LARGE_FLOAT) if t_max is None
             else l2(t_max.astype(jnp.float32)))

    def _slab_test(rowt, rox, roy, roz, rix, riy, riz, best_t):
        """Child slab test over all WIDTH children: (hc (C,B,P) bool,
        entry tmin (C,B,P) f32 for child ordering).  One body for both
        loop variants so the subgraph shapes match (bit-stability rule,
        see sub_step_mf docstring); f32 by default, conservative bf16
        when ``bf16_slab`` (visit superset — hits identical)."""
        gx, gy, gz = (_bitcast_f32(rowt[0]), _bitcast_f32(rowt[1]),
                      _bitcast_f32(rowt[2]))            # (B,)
        sx, sy, sz = (_bitcast_f32(rowt[3]), _bitcast_f32(rowt[4]),
                      _bitcast_f32(rowt[5]))
        qlc = jnp.stack([rowt[qoff + c] for c in range(w_)])     # (C, B)
        qhc = jnp.stack([rowt[hoff + c] for c in range(w_)])
        if not bf16_slab:
            def corner(q, sh, g, sc):  # (C, B) packed bytes -> (C, B, 1)
                f = ((q >> sh) & 255).astype(jnp.float32) if sh else \
                    (q & 255).astype(jnp.float32)
                return (g[None] + f * sc[None])[:, :, None]

            lx = corner(qlc, 0, gx, sx); hx = corner(qhc, 0, gx, sx)
            ly = corner(qlc, 8, gy, sy); hy = corner(qhc, 8, gy, sy)
            lz = corner(qlc, 16, gz, sz); hz = corner(qhc, 16, gz, sz)
            t1x = (lx - rox[None]) * rix[None]
            t2x = (hx - rox[None]) * rix[None]
            t1y = (ly - roy[None]) * riy[None]
            t2y = (hy - roy[None]) * riy[None]
            t1z = (lz - roz[None]) * riz[None]
            t2z = (hz - roz[None]) * riz[None]
            tmin = jnp.maximum(
                jnp.maximum(jnp.minimum(t1x, t2x), jnp.minimum(t1y, t2y)),
                jnp.minimum(t1z, t2z))
            tmax = jnp.minimum(
                jnp.minimum(jnp.maximum(t1x, t2x), jnp.maximum(t1y, t2y)),
                jnp.maximum(t1z, t2z))
            hc = (tmax >= tmin) & (tmax > 0.0) & (tmin < best_t[None])
            return hc, tmin
        # ---- conservative bf16 variant (see _BF16_SLAB_DEFAULT) ----
        bf = jnp.bfloat16
        pad = jnp.asarray(2.0 ** -6, bf)
        # node-local ray origin: f32 subtract (cancellation-safe), then
        # cast — 3 (B,P) ops, vs bf16-ing world coords which would need
        # an absolute pad proportional to |origin|
        rlx = (rox - gx[:, None]).astype(bf)
        rly = (roy - gy[:, None]).astype(bf)
        rlz = (roz - gz[:, None]).astype(bf)
        rixb, riyb, rizb = (rix.astype(bf), riy.astype(bf),
                            riz.astype(bf))
        sxb, syb, szb = sx.astype(bf), sy.astype(bf), sz.astype(bf)

        def cornerb(q, sh, sc, dlt):
            # +-1 LSB widen; q*2^e is EXACT in bf16 (q+dlt in -1..256,
            # 8-bit significand; scale a power of two)
            f = (((q >> sh) & 255) if sh else (q & 255)).astype(bf)
            return ((f + bf(dlt)) * sc[None])[:, :, None]

        lx = cornerb(qlc, 0, sxb, -1.0); hx = cornerb(qhc, 0, sxb, 1.0)
        ly = cornerb(qlc, 8, syb, -1.0); hy = cornerb(qhc, 8, syb, 1.0)
        lz = cornerb(qlc, 16, szb, -1.0); hz = cornerb(qhc, 16, szb, 1.0)
        t1x = (lx - rlx[None]) * rixb[None]
        t2x = (hx - rlx[None]) * rixb[None]
        t1y = (ly - rly[None]) * riyb[None]
        t2y = (hy - rly[None]) * riyb[None]
        t1z = (lz - rlz[None]) * rizb[None]
        t2z = (hz - rlz[None]) * rizb[None]
        tmin = jnp.maximum(
            jnp.maximum(jnp.minimum(t1x, t2x), jnp.minimum(t1y, t2y)),
            jnp.minimum(t1z, t2z))
        tmax = jnp.minimum(
            jnp.minimum(jnp.maximum(t1x, t2x), jnp.maximum(t1y, t2y)),
            jnp.maximum(t1z, t2z))
        # relative pads cover the multiply/cast roundings (<= ~5*2^-8)
        tmin_c = tmin - jnp.abs(tmin) * pad
        tmax_c = tmax + jnp.abs(tmax) * pad
        btb = best_t.astype(bf)
        thr = jnp.where(jnp.isfinite(btb),
                        btb + jnp.abs(btb) * pad, btb)
        hc = (tmax_c >= tmin_c) & (tmax_c > jnp.asarray(0.0, bf)) \
            & (tmin_c < thr[None])
        return hc, tmin_c.astype(jnp.float32)

    zi = jnp.zeros(b, jnp.int32)
    if array_stack:
        st_push, st_pop = _stack_push_a, _stack_pop_a

        def st_top(st):
            return st[:, 0]

        def st_set_top(st, v):
            return st.at[:, 0].set(v)

        st0_ = jnp.zeros((b, stack_n), jnp.int32)
    else:
        st_push, st_pop = _stack_push_n, _stack_pop_n

        def st_top(st):
            return st[0]

        def st_set_top(st, v):
            return (v,) + tuple(st[1:])

        st0_ = (zi,) * stack_n
    if fronts > 1:
        # per-front node lanes as a tuple of (B,) leaves (compaction's
        # generic axis-0 row gather then needs no special-casing), plus
        # a per-front "holds a valid node" flag; front 0 starts at root
        state = dict(
            node=(zi,) * fronts,
            f_on=((jnp.ones(b, bool),)
                  + (jnp.zeros(b, bool),) * (fronts - 1)),
            stack=st0_, scount=zi,
        )
    else:
        state = dict(
            node=zi,
            stack=st0_, scount=zi,
        )
    if w_ >= 8:
        state.update(stack2=st0_)
    if w_ == 16:
        state.update(stack3=st0_)
    if not flat:
        state.update(
            inst=zi,
            lox=ox, loy=oy, loz=oz, ldx=dx, ldy=dy, ldz=dz,
            lix=ivx, liy=ivy, liz=ivz)
    state.update(
        # dead lanes carry best_t = -LARGE_FLOAT (not -1): best_t doubles
        # as the liveness register in the slab test (tmin < best_t), and
        # real tmin values can sit far below -1 (origin deep inside a
        # large box) — this is what lets the loop body drop every ray_on
        # read (dead lanes fail all best_t comparisons by construction)
        best_t=jnp.where(ray_on, limit, -LARGE_FLOAT),
        bx=jnp.zeros((b, p), jnp.float32),
        by=jnp.zeros((b, p), jnp.float32),
        tri=jnp.zeros((b, p), jnp.int32),
        done=~jnp.any(ray_on, axis=1),
        steps=jnp.int32(0),
    )
    if not flat:
        state.update(best_inst=jnp.zeros((b, p), jnp.int32))
    if mixed:
        # per-packet mode flag (mixed occlusion/closest wave); part of
        # the state so compaction's packet gathers carry it along
        state.update(is_occ=jnp.arange(b, dtype=jnp.int32)
                     < (occl_split // p))
    if stats:
        # ray_steps accumulates live-ray counts per iteration and can
        # exceed 2^31 on 1080p bounce waves — carried as f32 (indicative)
        state.update(packet_steps=jnp.int32(0), ray_steps=jnp.float32(0),
                     int_steps=jnp.int32(0), tri_steps=jnp.int32(0),
                     ins_steps=jnp.int32(0))
    keys = list(state.keys())
    inv = dict(ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz,
               ivx=ivx, ivy=ivy, ivz=ivz, ray_on=ray_on)

    def _round(st0, iv, bb, target):
        """One while_loop over ``bb`` packets; with ``target`` > 0 the
        loop ALSO exits once <= target packets remain live (the driver
        then compacts the live packets into a target-sized array).  The
        enclosing-scope names are shadowed so the body below reads this
        round's arrays."""
        ox, oy, oz = iv["ox"], iv["oy"], iv["oz"]
        dx, dy, dz = iv["dx"], iv["dy"], iv["dz"]
        ivx, ivy, ivz = iv["ivx"], iv["ivy"], iv["ivz"]
        ray_on = iv["ray_on"]
        b = bb

        def cond(sl):
            s = dict(zip(keys, sl))
            go = jnp.logical_and(jnp.any(~s["done"]),
                                 s["steps"] < max_steps)
            if target:
                go = jnp.logical_and(
                    go, jnp.sum(~s["done"], dtype=jnp.int32) > target)
            return go

        def sub_step(sl):
            s = dict(zip(keys, sl))
            act = ~s["done"]
            node = jnp.clip(s["node"], 0, n_pool - 1)
            if wa.fused is not None:
                # ONE gather serves both loop paths (node fields at the
                # same offsets; this node's inline leaf slots after nrow)
                grow = wa.fused[node].T             # (nrow+16L, B)
                rowt = grow[:nrow]
            else:
                rowt = wa.nodes[node].T             # (nrow, B): tiny gather
            meta = rowt[moff]
            kind = (meta >> 29).astype(jnp.int32)
            nch = ((meta >> lbits) & nmask).astype(jnp.int32)
            left = (meta & lmask).astype(jnp.int32)
            leaf_data = _bitcast_i32(rowt[loff])
            is_int = act & (kind == qbvh.KIND_INTERNAL)
            is_tri = act & (kind == qbvh.KIND_TRIS)
            stack, scount = s["stack"], s["scount"]

            if flat:
                is_ins = jnp.zeros(b, bool)
                rox, roy, roz, rix, riy, riz = ox, oy, oz, ivx, ivy, ivz
            else:
                is_ins = act & (kind == qbvh.KIND_INSTANCE)
                in_tlas = (node < wa.num_tlas)[:, None]
                rox = jnp.where(in_tlas, ox, s["lox"])
                roy = jnp.where(in_tlas, oy, s["loy"])
                roz = jnp.where(in_tlas, oz, s["loz"])
                rix = jnp.where(in_tlas, ivx, s["lix"])
                riy = jnp.where(in_tlas, ivy, s["liy"])
                riz = jnp.where(in_tlas, ivz, s["liz"])

            # ---- internal: batched packet-vs-children slab tests ----
            # all WIDTH children in one (C, B, P) op chain (op count, not
            # FLOPs, bounds the loop body — see module docstring).
            # per-ray prune is sound here because the overflow-proof
            # stack guarantees no trail restarts (see module docstring);
            # dead/retired lanes fail tmin < best_t (= -LARGE_FLOAT)
            hc, tmin = _slab_test(rowt, rox, roy, roz, rix, riy, riz,
                                  s["best_t"])
            any_hit = (jnp.any(hc, axis=2)
                       & (jnp.arange(w_, dtype=jnp.int32)[:, None]
                          < nch[None]))                     # (C, B)
            pd = jnp.min(jnp.where(hc, tmin, LARGE_FLOAT), axis=2)
            pdm = jnp.where(any_hit, pd, _MISS)
            m = jnp.sum((pdm > _MISS).astype(jnp.int32), axis=0)
            if lax_sort:
                # far -> near as ONE fused variadic sort (key = -dist
                # ascending); misses (_MISS = -LARGE) key to +LARGE and
                # land past position m-1, same layout as the network.
                # Stable ties = child-slot order; traversal order among
                # equal-tmin children never changes final hits (every
                # unpruned child is still visited), so hits stay
                # bit-identical — only step counts may shift.
                _, sidx = jax.lax.sort(
                    (-pdm, jnp.broadcast_to(
                        jnp.arange(w_, dtype=jnp.int32)[:, None],
                        (w_, b))),
                    dimension=0, is_stable=True, num_keys=1)
                idxs = [sidx[c] for c in range(w_)]
            else:
                dists = [pdm[c] for c in range(w_)]
                idxs = [jnp.full(b, c, jnp.int32) for c in range(w_)]
                # far -> near by packet-min entry distance (desc sorting
                # network)
                for a_i, b_i in _SORT_NET[w_]:
                    swap = dists[a_i] < dists[b_i]
                    da, db = dists[a_i], dists[b_i]
                    ia, ib = idxs[a_i], idxs[b_i]
                    dists[a_i] = jnp.where(swap, db, da)
                    dists[b_i] = jnp.where(swap, da, db)
                    idxs[a_i] = jnp.where(swap, ib, ia)
                    idxs[b_i] = jnp.where(swap, ia, ib)

            pos_closest = m - 1
            descend = is_int & (m >= 1)
            want_pop_int = is_int & (m < 1)
            child_slot = _at_pos(idxs, pos_closest)
            next_int = left + child_slot
            # defer the other m-1 children in packed words (near-first
            # pop order: field (count-1) is read first = idxs[m-2], the
            # nearest deferred child — identical visit order to pushing
            # far->near entries individually)
            if w_ == 4:
                cnt_def = jnp.clip(m - 1, 0, 3)
                word = ((left << 8) | (cnt_def << 6)
                        | (idxs[0] & 3) | ((idxs[1] & 3) << 2)
                        | ((idxs[2] & 3) << 4))
                stack, scount = st_push(stack, scount, word,
                                        descend & (cnt_def >= 1))
            elif w_ == 8:
                cnt_def = jnp.clip(m - 1, 0, 7)
                word0 = (left << 4) | cnt_def
                word1 = idxs[0] & 7
                for j in range(1, 7):
                    word1 = word1 | ((idxs[j] & 7) << (3 * j))
                push_mask = descend & (cnt_def >= 1)
                stack2 = s["stack2"]
                stack2, _ = st_push(stack2, scount, word1, push_mask)
                stack, scount = st_push(stack, scount, word0, push_mask)
            else:
                cnt_def = jnp.clip(m - 1, 0, 15)
                word0 = (left << 4) | cnt_def
                word1 = idxs[0] & 15
                for j in range(1, 8):
                    word1 = word1 | ((idxs[j] & 15) << (4 * j))
                word2 = idxs[8] & 15
                for j in range(9, 15):
                    word2 = word2 | ((idxs[j] & 15) << (4 * (j - 8)))
                push_mask = descend & (cnt_def >= 1)
                stack2, stack3 = s["stack2"], s["stack3"]
                stack3, _ = st_push(stack3, scount, word2, push_mask)
                stack2, _ = st_push(stack2, scount, word1, push_mask)
                stack, scount = st_push(stack, scount, word0, push_mask)

            if flat:
                lox, loy, loz = ox, oy, oz
                ldx_, ldy_, ldz_ = dx, dy, dz
            else:
                # ---- instance leaf: whole packet swaps into object space ----
                mm = [_bitcast_f32(rowt[16 + k])[:, None] for k in range(12)]
                nlox = mm[0] * ox + mm[1] * oy + mm[2] * oz + mm[3]
                nloy = mm[4] * ox + mm[5] * oy + mm[6] * oz + mm[7]
                nloz = mm[8] * ox + mm[9] * oy + mm[10] * oz + mm[11]
                nldx = mm[0] * dx + mm[1] * dy + mm[2] * dz
                nldy = mm[4] * dx + mm[5] * dy + mm[6] * dz
                nldz = mm[8] * dx + mm[9] * dy + mm[10] * dz
                em = is_ins[:, None]
                inst = jnp.where(is_ins, left, s["inst"])
                lox = jnp.where(em, nlox, s["lox"])
                loy = jnp.where(em, nloy, s["loy"])
                loz = jnp.where(em, nloz, s["loz"])
                ldx_ = jnp.where(em, nldx, s["ldx"])
                ldy_ = jnp.where(em, nldy, s["ldy"])
                ldz_ = jnp.where(em, nldz, s["ldz"])
                lix = jnp.where(em, _rcp_lane(nldx), s["lix"])
                liy = jnp.where(em, _rcp_lane(nldy), s["liy"])
                liz = jnp.where(em, _rcp_lane(nldz), s["liz"])
                next_ins = _bitcast_i32(rowt[28])

            # ---- triangle leaf: batched Moller-Trumbore over leaf slots ----
            # all lmax triangles in one (L, B, P) op chain; the winner fold
            # below is lmax cheap (B, P) compare/select steps
            if wa.fused is not None:
                lrowt = _bitcast_f32(grow[nrow:])   # this node's own slots
            else:
                lrowt = wa.tri_rows[
                    jnp.clip(left, 0, n_leaf_rows - 1)].T      # (C, B)
            cnt = leaf_data

            def lf(k):  # leaf field k across slots -> (L, B, 1)
                return jnp.stack([lrowt[16 * c + k]
                                  for c in range(lmax)])[:, :, None]

            v0x, v0y, v0z = lf(0), lf(1), lf(2)
            e1x, e1y, e1z = lf(3), lf(4), lf(5)
            e2x, e2y, e2z = lf(6), lf(7), lf(8)
            tid = jnp.stack([_bitcast_i32(lrowt[16 * c + 9])
                             for c in range(lmax)])          # (L, B)
            ld_x, ld_y, ld_z = ldx_[None], ldy_[None], ldz_[None]
            hx_ = ld_y * e2z - ld_z * e2y
            hy_ = ld_z * e2x - ld_x * e2z
            hz_ = ld_x * e2y - ld_y * e2x
            a = e1x * hx_ + e1y * hy_ + e1z * hz_
            fba = 1.0 / jnp.where(jnp.abs(a) < eps, 1.0, a)
            sx_ = lox[None] - v0x
            sy_ = loy[None] - v0y
            sz_ = loz[None] - v0z
            w1 = fba * (sx_ * hx_ + sy_ * hy_ + sz_ * hz_)
            qx = sy_ * e1z - sz_ * e1y
            qy = sz_ * e1x - sx_ * e1z
            qz = sx_ * e1y - sy_ * e1x
            w2 = fba * (ld_x * qx + ld_y * qy + ld_z * qz)
            t = fba * (e2x * qx + e2y * qy + e2z * qz)
            ok = ((jnp.abs(a) >= eps) & (w1 >= 0.0) & (w1 <= 1.0)
                  & (w2 >= 0.0) & (w1 + w2 <= 1.0) & (t > eps)
                  & (jnp.arange(lmax, dtype=jnp.int32)[:, None, None]
                     < cnt[None, :, None])
                  & is_tri[None, :, None])
            if anyhit_pred is not None:
                # ---- in-loop stateless any-hit (COMMIT_CONT analog):
                # reject candidates the predicate declines (alpha test,
                # uv cutouts, ...).  One (8L, B) row gather (same index
                # as the leaf row) + one alpha-pool gather; uv
                # interpolation and the point-sample texel address
                # reproduce shade_point's op order exactly, so
                # acceptance decisions match the suspension engine
                # bit-for-bit.  With fused_alpha the fields ride the
                # node-row gather already in hand (zero extra gathers at
                # this chain depth).
                if fused_alpha:
                    arow = _bitcast_f32(grow[nrow + 16 * lmax:])  # (8L, B)
                else:
                    arow = wa.alpha_rows[
                        jnp.clip(left, 0, n_leaf_rows - 1)].T   # (8L, B)

                def af(k):  # alpha field k across slots -> (L, B, 1)
                    return jnp.stack([arow[8 * c + k]
                                      for c in range(lmax)])[:, :, None]

                bz_c = 1.0 - w1 - w2
                # uv = uv1*bx + uv2*by + uv0*bz (closest.cpp:77)
                u_c = af(2) * w1 + af(4) * w2 + af(0) * bz_c
                v_c = af(3) * w1 + af(5) * w2 + af(1) * bz_c
                toff_a = jnp.stack(
                    [_bitcast_i32(arow[8 * c + 6])
                     for c in range(lmax)])[:, :, None]
                twh_a = jnp.stack(
                    [_bitcast_i32(arow[8 * c + 7])
                     for c in range(lmax)])[:, :, None]
                tw_a = twh_a >> 16
                th_a = twh_a & 0xFFFF
                iu = jnp.floor(u_c * tw_a).astype(jnp.int32) % tw_a
                iv = jnp.floor(v_c * th_a).astype(jnp.int32) % th_a
                idx = toff_a + iu + iv * tw_a
                alpha = wa.alpha_pool[
                    jnp.clip(idx, 0, wa.alpha_pool.shape[0] - 1)]
                ok = ok & anyhit_pred(u_c, v_c, alpha)
            t = jnp.where(ok, t, LARGE_FLOAT)                # (L, B, P)
            t_min = jnp.full((b, p), LARGE_FLOAT)
            tid_sel = jnp.full((b, p), _INT_MAX)
            w1_sel = jnp.zeros((b, p), jnp.float32)
            w2_sel = jnp.zeros((b, p), jnp.float32)
            for c in range(lmax):
                tc = t[c]
                tid_b = jnp.broadcast_to(tid[c][:, None], (b, p))
                better = (tc < t_min) | ((tc == t_min) & (tc < LARGE_FLOAT)
                                         & (tid_b < tid_sel))
                t_min = jnp.where(better, tc, t_min)
                tid_sel = jnp.where(better, tid_b, tid_sel)
                w1_sel = jnp.where(better, w1[c], w1_sel)
                w2_sel = jnp.where(better, w2[c], w2_sel)

            if occlusion:
                # any hit inside the clamp retires the ray: best_t drops to
                # -LARGE_FLOAT (the dead-lane value), killing its slab tests
                # so it stops widening the packet union
                occ_new = is_tri[:, None] & (t_min < s["best_t"])
                best_t = jnp.where(occ_new, -LARGE_FLOAT, s["best_t"])
                bx, by = s["bx"], s["by"]
                tri = s["tri"]
                if not flat:
                    best_inst = s["best_inst"]
            else:
                closer = is_tri[:, None] & (t_min < s["best_t"])
                tie = (is_tri[:, None] & (t_min == s["best_t"])
                       & (t_min < LARGE_FLOAT))
                if flat:
                    # packed (inst << tri_bits) | tri compare IS the
                    # (inst, tri) lexicographic tie-break
                    tie_better = tie & (tid_sel < s["tri"])
                else:
                    inst_b = jnp.broadcast_to(inst[:, None], (b, p))
                    tie_better = tie & ((inst_b < s["best_inst"])
                                        | ((inst_b == s["best_inst"])
                                           & (tid_sel < s["tri"])))
                upd = closer | tie_better
                if mixed:
                    # occlusion-mode packets retire rays at first hit
                    # instead of the closest-hit update
                    occ_pk = s["is_occ"][:, None]
                    occ_new = (occ_pk & is_tri[:, None]
                               & (t_min < s["best_t"]))
                    upd = upd & ~occ_pk
                best_t = jnp.where(upd, t_min, s["best_t"])
                bx = jnp.where(upd, w1_sel, s["bx"])
                by = jnp.where(upd, w2_sel, s["by"])
                tri = jnp.where(upd, tid_sel, s["tri"])
                if not flat:
                    best_inst = jnp.where(upd, inst_b, s["best_inst"])
                if mixed:
                    best_t = jnp.where(occ_new, -LARGE_FLOAT, best_t)
            want_pop_tri = is_tri

            # ---- next / pop (per packet) ----
            if flat:
                nxt = jnp.where(descend, next_int, s["node"])
            else:
                nxt = jnp.where(is_int,
                                jnp.where(descend, next_int, s["node"]),
                                jnp.where(is_ins, next_ins, s["node"]))
            want_pop = want_pop_int | want_pop_tri
            empty = scount == 0
            dead = want_pop & empty        # stack drained => walk complete
            do_pop = want_pop & ~empty
            top = st_top(stack)
            if w_ == 4:
                c_top = (top >> 6) & 3
                slot = (top >> (2 * jnp.maximum(c_top - 1, 0))) & 3
                node_pop = (top >> 8) + slot
                # most pops just decrement the top word's count field in
                # place; the last child pops the word off the register
                partial = do_pop & (c_top > 1)
                s0 = jnp.where(partial, top - 64, top)
                stack = st_set_top(stack, s0)
                _, stack, scount = st_pop(stack, scount,
                                          do_pop & (c_top <= 1))
            elif w_ == 8:
                c_top = top & 15
                slot = (st_top(stack2)
                        >> (3 * jnp.maximum(c_top - 1, 0))) & 7
                node_pop = (top >> 4) + slot
                partial = do_pop & (c_top > 1)
                s0 = jnp.where(partial, top - 1, top)
                stack = st_set_top(stack, s0)
                full_pop = do_pop & (c_top <= 1)
                _, stack2, _ = st_pop(stack2, scount, full_pop)
                _, stack, scount = st_pop(stack, scount, full_pop)
            else:
                c_top = top & 15
                j = jnp.maximum(c_top - 1, 0)
                slot = jnp.where(
                    j < 8, (st_top(stack2) >> (4 * j)) & 15,
                    (st_top(stack3) >> (4 * jnp.maximum(j - 8, 0))) & 15)
                node_pop = (top >> 4) + slot
                partial = do_pop & (c_top > 1)
                s0 = jnp.where(partial, top - 1, top)
                stack = st_set_top(stack, s0)
                full_pop = do_pop & (c_top <= 1)
                _, stack3, _ = st_pop(stack3, scount, full_pop)
                _, stack2, _ = st_pop(stack2, scount, full_pop)
                _, stack, scount = st_pop(stack, scount, full_pop)
            nxt = jnp.where(do_pop, node_pop, nxt)

            done = s["done"] | dead
            if occlusion:
                done = done | ~jnp.any(best_t > 0.0, axis=1)
            elif mixed:
                done = done | (s["is_occ"]
                               & ~jnp.any(best_t > 0.0, axis=1))
            if stats:
                live = act.sum(dtype=jnp.int32)
                s["packet_steps"] = s["packet_steps"] + live
                s["ray_steps"] = s["ray_steps"] + jnp.sum(
                    (ray_on & act[:, None]).sum(1, dtype=jnp.int32),
                    dtype=jnp.float32)
                s["int_steps"] = s["int_steps"] + is_int.sum(dtype=jnp.int32)
                s["tri_steps"] = s["tri_steps"] + is_tri.sum(dtype=jnp.int32)
                s["ins_steps"] = s["ins_steps"] + is_ins.sum(dtype=jnp.int32)
            s.update(node=nxt, stack=stack, scount=scount,
                     best_t=best_t, bx=bx, by=by, tri=tri,
                     done=done, steps=s["steps"] + 1)
            if w_ >= 8:
                s.update(stack2=stack2)
            if w_ == 16:
                s.update(stack3=stack3)
            if not flat:
                s.update(inst=inst, lox=lox, loy=loy, loz=loz,
                         ldx=ldx_, ldy=ldy_, ldz=ldz_,
                         lix=lix, liy=liy, liz=liz, best_inst=best_inst)
            return [s[k] for k in keys]

        def sub_step_mf(sl):
            """Multi-front walk step (fronts > 1, flat builds): F stack
            nodes per packet per iteration through ONE (F*B,)-row gather;
            the fronts push/pop one shared packed-word stack in fixed
            front order (sequential masked ops), so the union DFS is
            simply consumed F nodes at a time.

            Each front's slab/sort/MT chains run at the SINGLE-front
            shapes ((C,B,P)/(L,B,P)) with best_t threaded sequentially
            between fronts — semantically two consecutive single-front
            iterations that happen to share one gather.  An F-axis-
            batched variant was measurably NOT bit-identical: XLA
            contracts mul+add chains differently at (L,F,B,P) than at
            (L,B,P) (last-ulp bary drift on 12% of rays) — same-shaped
            subgraphs are the empirically bit-stable form (the same
            property packet-size/compaction variants already rely on).
            Visit sets form a superset of single-front's (a front's
            prune may lag a sibling's same-iteration fold), but each
            ray's hit is the lexicographic (t, id) min over its own
            candidates — composition-independent."""
            F = fronts
            s = dict(zip(keys, sl))
            act = ~s["done"]
            stack, scount = s["stack"], s["scount"]
            if w_ >= 8:
                stack2 = s["stack2"]
            if w_ == 16:
                stack3 = s["stack3"]
            best_t, bx, by, tri = s["best_t"], s["bx"], s["by"], s["tri"]
            if mixed:
                occ_pk = s["is_occ"][:, None]

            # ---- ONE gather serves all fronts (the latency win: one
            # 2B-row gather instead of two separate B-row gathers) ----
            flat_idx = jnp.concatenate(
                [jnp.clip(n, 0, n_pool - 1) for n in s["node"]])
            if wa.fused is not None:
                grow_all = wa.fused[flat_idx].T        # (nrow+16L, F*B)
            else:
                grow_all = wa.nodes[flat_idx].T        # (nrow, F*B)

            descend_f, next_f, want_pop_f = [], [], []
            int_ct = tri_ct = None
            for f in range(F):
                rowt = grow_all[:nrow, f * b:(f + 1) * b]  # (nrow, B)
                on_f = s["f_on"][f] & act
                meta = rowt[moff]
                kind = (meta >> 29).astype(jnp.int32)
                nch = ((meta >> lbits) & nmask).astype(jnp.int32)
                left = (meta & lmask).astype(jnp.int32)
                leaf_data = _bitcast_i32(rowt[loff])
                is_int = on_f & (kind == qbvh.KIND_INTERNAL)
                is_tri = on_f & (kind == qbvh.KIND_TRIS)
                if stats:
                    int_ct = (is_int.sum(dtype=jnp.int32) if int_ct is None
                              else int_ct + is_int.sum(dtype=jnp.int32))
                    tri_ct = (is_tri.sum(dtype=jnp.int32) if tri_ct is None
                              else tri_ct + is_tri.sum(dtype=jnp.int32))

                # ---- internal: batched slab tests (single-front form,
                # pruned against the front-sequential best_t) ----
                hc, tmin = _slab_test(rowt, ox, oy, oz, ivx, ivy, ivz,
                                      best_t)
                any_hit = (jnp.any(hc, axis=2)
                           & (jnp.arange(w_, dtype=jnp.int32)[:, None]
                              < nch[None]))
                pd = jnp.min(jnp.where(hc, tmin, LARGE_FLOAT), axis=2)
                pdm = jnp.where(any_hit, pd, _MISS)
                m = jnp.sum((pdm > _MISS).astype(jnp.int32), axis=0)
                if lax_sort:
                    _, sidx = jax.lax.sort(
                        (-pdm, jnp.broadcast_to(
                            jnp.arange(w_, dtype=jnp.int32)[:, None],
                            (w_, b))),
                        dimension=0, is_stable=True, num_keys=1)
                    idxs = [sidx[c] for c in range(w_)]
                else:
                    dists = [pdm[c] for c in range(w_)]
                    idxs = [jnp.full(b, c, jnp.int32) for c in range(w_)]
                    for a_i, b_i in _SORT_NET[w_]:
                        swap = dists[a_i] < dists[b_i]
                        da, db = dists[a_i], dists[b_i]
                        ia, ib = idxs[a_i], idxs[b_i]
                        dists[a_i] = jnp.where(swap, db, da)
                        dists[b_i] = jnp.where(swap, da, db)
                        idxs[a_i] = jnp.where(swap, ib, ia)
                        idxs[b_i] = jnp.where(swap, ia, ib)

                descend = is_int & (m >= 1)
                child_slot = _at_pos(idxs, m - 1)
                if w_ == 4:
                    cnt_def = jnp.clip(m - 1, 0, 3)
                    word = ((left << 8) | (cnt_def << 6)
                            | (idxs[0] & 3) | ((idxs[1] & 3) << 2)
                            | ((idxs[2] & 3) << 4))
                    stack, scount = st_push(stack, scount, word,
                                            descend & (cnt_def >= 1))
                elif w_ == 8:
                    cnt_def = jnp.clip(m - 1, 0, 7)
                    word0 = (left << 4) | cnt_def
                    word1 = idxs[0] & 7
                    for j in range(1, 7):
                        word1 = word1 | ((idxs[j] & 7) << (3 * j))
                    push_mask = descend & (cnt_def >= 1)
                    stack2, _ = st_push(stack2, scount, word1, push_mask)
                    stack, scount = st_push(stack, scount, word0,
                                            push_mask)
                else:
                    cnt_def = jnp.clip(m - 1, 0, 15)
                    word0 = (left << 4) | cnt_def
                    word1 = idxs[0] & 15
                    for j in range(1, 8):
                        word1 = word1 | ((idxs[j] & 15) << (4 * j))
                    word2 = idxs[8] & 15
                    for j in range(9, 15):
                        word2 = word2 | ((idxs[j] & 15) << (4 * (j - 8)))
                    push_mask = descend & (cnt_def >= 1)
                    stack3, _ = st_push(stack3, scount, word2, push_mask)
                    stack2, _ = st_push(stack2, scount, word1, push_mask)
                    stack, scount = st_push(stack, scount, word0,
                                            push_mask)

                # ---- triangle leaf: single-front-shaped MT fold ----
                if wa.fused is not None:
                    lrowt = _bitcast_f32(
                        grow_all[nrow:, f * b:(f + 1) * b])
                else:
                    lrowt = wa.tri_rows[
                        jnp.clip(left, 0, n_leaf_rows - 1)].T
                cnt = leaf_data

                def lf(k, lrowt=lrowt):
                    return jnp.stack([lrowt[16 * c + k]
                                      for c in range(lmax)])[:, :, None]

                v0x, v0y, v0z = lf(0), lf(1), lf(2)
                e1x, e1y, e1z = lf(3), lf(4), lf(5)
                e2x, e2y, e2z = lf(6), lf(7), lf(8)
                tid = jnp.stack([_bitcast_i32(lrowt[16 * c + 9])
                                 for c in range(lmax)])
                ld_x, ld_y, ld_z = dx[None], dy[None], dz[None]
                hx_ = ld_y * e2z - ld_z * e2y
                hy_ = ld_z * e2x - ld_x * e2z
                hz_ = ld_x * e2y - ld_y * e2x
                a = e1x * hx_ + e1y * hy_ + e1z * hz_
                fba = 1.0 / jnp.where(jnp.abs(a) < eps, 1.0, a)
                sx_ = ox[None] - v0x
                sy_ = oy[None] - v0y
                sz_ = oz[None] - v0z
                w1 = fba * (sx_ * hx_ + sy_ * hy_ + sz_ * hz_)
                qx = sy_ * e1z - sz_ * e1y
                qy = sz_ * e1x - sx_ * e1z
                qz = sx_ * e1y - sy_ * e1x
                w2 = fba * (ld_x * qx + ld_y * qy + ld_z * qz)
                t = fba * (e2x * qx + e2y * qy + e2z * qz)
                ok = ((jnp.abs(a) >= eps) & (w1 >= 0.0) & (w1 <= 1.0)
                      & (w2 >= 0.0) & (w1 + w2 <= 1.0) & (t > eps)
                      & (jnp.arange(lmax, dtype=jnp.int32)[:, None, None]
                         < cnt[None, :, None])
                      & is_tri[None, :, None])
                if anyhit_pred is not None:
                    if fused_alpha:
                        arow = _bitcast_f32(
                            grow_all[nrow + 16 * lmax:, f * b:(f + 1) * b])
                    else:
                        arow = wa.alpha_rows[
                            jnp.clip(left, 0, n_leaf_rows - 1)].T

                    def af(k, arow=arow):
                        return jnp.stack([arow[8 * c + k]
                                          for c in range(lmax)])[:, :, None]

                    bz_c = 1.0 - w1 - w2
                    u_c = af(2) * w1 + af(4) * w2 + af(0) * bz_c
                    v_c = af(3) * w1 + af(5) * w2 + af(1) * bz_c
                    toff_a = jnp.stack(
                        [_bitcast_i32(arow[8 * c + 6])
                         for c in range(lmax)])[:, :, None]
                    twh_a = jnp.stack(
                        [_bitcast_i32(arow[8 * c + 7])
                         for c in range(lmax)])[:, :, None]
                    tw_a = twh_a >> 16
                    th_a = twh_a & 0xFFFF
                    iu = jnp.floor(u_c * tw_a).astype(jnp.int32) % tw_a
                    iv = jnp.floor(v_c * th_a).astype(jnp.int32) % th_a
                    idx = toff_a + iu + iv * tw_a
                    alpha = wa.alpha_pool[
                        jnp.clip(idx, 0, wa.alpha_pool.shape[0] - 1)]
                    ok = ok & anyhit_pred(u_c, v_c, alpha)
                t = jnp.where(ok, t, LARGE_FLOAT)
                t_min = jnp.full((b, p), LARGE_FLOAT)
                tid_sel = jnp.full((b, p), _INT_MAX)
                w1_sel = jnp.zeros((b, p), jnp.float32)
                w2_sel = jnp.zeros((b, p), jnp.float32)
                for c in range(lmax):
                    tc = t[c]
                    tid_b = jnp.broadcast_to(tid[c][:, None], (b, p))
                    better = (tc < t_min) | ((tc == t_min)
                                             & (tc < LARGE_FLOAT)
                                             & (tid_b < tid_sel))
                    t_min = jnp.where(better, tc, t_min)
                    tid_sel = jnp.where(better, tid_b, tid_sel)
                    w1_sel = jnp.where(better, w1[c], w1_sel)
                    w2_sel = jnp.where(better, w2[c], w2_sel)

                if occlusion:
                    occ_new = is_tri[:, None] & (t_min < best_t)
                    best_t = jnp.where(occ_new, -LARGE_FLOAT, best_t)
                else:
                    closer = is_tri[:, None] & (t_min < best_t)
                    tie = (is_tri[:, None] & (t_min == best_t)
                           & (t_min < LARGE_FLOAT))
                    tie_better = tie & (tid_sel < tri)
                    upd = closer | tie_better
                    if mixed:
                        occ_new = (occ_pk & is_tri[:, None]
                                   & (t_min < best_t))
                        upd = upd & ~occ_pk
                    best_t = jnp.where(upd, t_min, best_t)
                    bx = jnp.where(upd, w1_sel, bx)
                    by = jnp.where(upd, w2_sel, by)
                    tri = jnp.where(upd, tid_sel, tri)
                    if mixed:
                        best_t = jnp.where(occ_new, -LARGE_FLOAT, best_t)

                descend_f.append(descend)
                next_f.append(jnp.where(descend, left + child_slot,
                                        s["node"][f]))
                want_pop_f.append(act & ~descend)

            # ---- pops: sequential per front on the shared stack ----
            nxt = list(next_f)
            new_on = []
            for f in range(F):
                empty = scount == 0
                do_pop = want_pop_f[f] & ~empty
                top = st_top(stack)
                if w_ == 4:
                    c_top = (top >> 6) & 3
                    slot = (top >> (2 * jnp.maximum(c_top - 1, 0))) & 3
                    node_pop = (top >> 8) + slot
                    partial = do_pop & (c_top > 1)
                    s0 = jnp.where(partial, top - 64, top)
                    stack = st_set_top(stack, s0)
                    _, stack, scount = st_pop(stack, scount,
                                              do_pop & (c_top <= 1))
                elif w_ == 8:
                    c_top = top & 15
                    slot = (st_top(stack2)
                            >> (3 * jnp.maximum(c_top - 1, 0))) & 7
                    node_pop = (top >> 4) + slot
                    partial = do_pop & (c_top > 1)
                    s0 = jnp.where(partial, top - 1, top)
                    stack = st_set_top(stack, s0)
                    full_pop = do_pop & (c_top <= 1)
                    _, stack2, _ = st_pop(stack2, scount, full_pop)
                    _, stack, scount = st_pop(stack, scount, full_pop)
                else:
                    c_top = top & 15
                    j = jnp.maximum(c_top - 1, 0)
                    slot = jnp.where(
                        j < 8, (st_top(stack2) >> (4 * j)) & 15,
                        (st_top(stack3)
                         >> (4 * jnp.maximum(j - 8, 0))) & 15)
                    node_pop = (top >> 4) + slot
                    partial = do_pop & (c_top > 1)
                    s0 = jnp.where(partial, top - 1, top)
                    stack = st_set_top(stack, s0)
                    full_pop = do_pop & (c_top <= 1)
                    _, stack3, _ = st_pop(stack3, scount, full_pop)
                    _, stack2, _ = st_pop(stack2, scount, full_pop)
                    _, stack, scount = st_pop(stack, scount, full_pop)
                nxt[f] = jnp.where(do_pop, node_pop, nxt[f])
                new_on.append(descend_f[f] | do_pop)

            any_on = new_on[0]
            for f in range(1, F):
                any_on = any_on | new_on[f]
            done = s["done"] | (act & ~any_on)
            if occlusion:
                done = done | ~jnp.any(best_t > 0.0, axis=1)
            elif mixed:
                done = done | (s["is_occ"]
                               & ~jnp.any(best_t > 0.0, axis=1))
            if stats:
                # packet_steps counts live packets x fronts: each live
                # packet's iteration gathers F node rows, so this is the
                # row-gather count — directly comparable across fronts
                # settings (render_stats rays_per_live_packet stays
                # consistent)
                live = act.sum(dtype=jnp.int32)
                s["packet_steps"] = s["packet_steps"] + live * fronts
                s["ray_steps"] = s["ray_steps"] + jnp.float32(fronts) * (
                    jnp.sum((ray_on & act[:, None]).sum(1, dtype=jnp.int32),
                            dtype=jnp.float32))
                s["int_steps"] = s["int_steps"] + int_ct
                s["tri_steps"] = s["tri_steps"] + tri_ct
            s.update(node=tuple(nxt), f_on=tuple(new_on),
                     stack=stack, scount=scount,
                     best_t=best_t, bx=bx, by=by, tri=tri,
                     done=done, steps=s["steps"] + 1)
            if w_ >= 8:
                s.update(stack2=stack2)
            if w_ == 16:
                s.update(stack3=stack3)
            return [s[k] for k in keys]
        step_fn = sub_step_mf if fronts > 1 else sub_step

        def body(sl):
            for _ in range(unroll):
                sl = step_fn(sl)
            return sl

        return dict(zip(keys, jax.lax.while_loop(
            cond, body, [st0[k] for k in keys])))

    # ---- straggler compaction (measured ~10% packet occupancy on 1080p
    # bounce waves: the while_loop iterates for its SLOWEST packet while
    # every other packet's state still pays per-iteration cost).  Run
    # the full-width loop only until <= B/4 packets remain live, gather
    # the live packets into a 4x smaller array, and repeat; the
    # straggler tail then iterates on cheap arrays.  Per-packet state
    # is self-contained, and completed hit fields scatter back to their
    # original rows after every round, so results are bit-identical.
    # VORTEX_RT_COMPACT_DIV (default 4) sets the round-shrink factor.
    # 2 halves the width between rounds: rounds whose target already
    # exceeds the live count at entry exit after ZERO iterations (cond
    # checks live <= target first), so low-entry-density waves — bounce
    # waves where most lanes never spawned — stop paying full-width
    # iterations almost immediately, at one argsort + row gather per
    # skipped round.  Bit-identical either way (compaction only moves
    # whole packets).
    targets = []
    if not stats:
        t_ = b // _COMPACT_DIV_DEFAULT
        while t_ >= 16:
            targets.append(t_)
            t_ //= _COMPACT_DIV_DEFAULT
    targets.append(0)

    hit_keys = ["best_t", "bx", "by", "tri"] + (
        [] if flat else ["best_inst"])
    if len(targets) == 1:
        final = _round(state, inv, b, 0)
    else:
        out = {k: state[k] for k in hit_keys}
        src = jnp.arange(b, dtype=jnp.int32)
        cur, cur_inv, cur_b = state, inv, b
        fin = None
        for target in targets:
            fin = _round(cur, cur_inv, cur_b, target)
            for k in hit_keys:
                out[k] = out[k].at[src].set(fin[k])
            if target == 0:
                break
            order = jnp.argsort(fin["done"])       # live rows first
            keep = order[:target]
            src = src[keep]
            cur = {k: (v if k == "steps"
                       else jax.tree.map(lambda a: a[keep], v))
                   for k, v in fin.items()}
            cur_inv = {k: v[keep] for k, v in cur_inv.items()}
            cur_b = target
        final = dict(out, steps=fin["steps"])

    def reshape_r(x):
        return x.reshape(r)

    if occlusion:
        occluded = ray_on & (final["best_t"] < 0.0)
        dist = reshape_r(jnp.where(occluded, 0.0, LARGE_FLOAT))
    elif mixed:
        occ_lane = jnp.broadcast_to(
            (jnp.arange(b, dtype=jnp.int32) < occl_split // p)[:, None],
            (b, p))
        occluded = ray_on & occ_lane & (final["best_t"] < 0.0)
        d_occ = jnp.where(occluded, 0.0, LARGE_FLOAT)
        d_clo = jnp.where((final["best_t"] < 0)
                          | (final["best_t"] >= limit),
                          LARGE_FLOAT, final["best_t"])
        dist = reshape_r(jnp.where(occ_lane, d_occ, d_clo))
    else:
        # a real hit is strictly inside the clamp; unhit rays still carry
        # their initial t_max and must report miss
        dist = reshape_r(jnp.where((final["best_t"] < 0)
                                   | (final["best_t"] >= limit),
                                   LARGE_FLOAT, final["best_t"]))
    if flat:
        # unpack (inst << tri_bits) | tri (miss lanes carry 0 -> (0, 0))
        tri_out = final["tri"] & ((1 << wa.tri_bits) - 1)
        inst_out = final["tri"] >> wa.tri_bits
    else:
        tri_out, inst_out = final["tri"], final["best_inst"]
    hits = Hits(
        dist=dist,
        bx=reshape_r(final["bx"]), by=reshape_r(final["by"]),
        bz=reshape_r(1.0 - final["bx"] - final["by"]),
        tri=reshape_r(tri_out), inst=reshape_r(inst_out),
    )
    if stats:
        return hits, PacketStats(
            steps=final["steps"], packet_steps=final["packet_steps"],
            ray_steps=final["ray_steps"], int_steps=final["int_steps"],
            tri_steps=final["tri_steps"], ins_steps=final["ins_steps"])
    return hits, final["steps"]
