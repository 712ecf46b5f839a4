"""Batched two-level BVH traversal (JAX) — the traceRay engine, take 1.

Functional match for the reference's traversal (BVHTraverser,
sim/simx/rt_traversal.cpp:26-213 + the raycast software path
tests/regression/raycast/render.h:74-188): closest-first descent with
far-child push, TLAS->BLAS instance jump with object-space ray transform,
Moller-Trumbore leaves, strict '<' hit updates.

Array-program redesign rather than a port:

* The reference walks one ray per SIMT lane with per-thread stacks in local
  memory.  Here the *whole ray batch* advances in lockstep through one
  ``lax.while_loop`` step machine: every per-ray scalar becomes an (R,)
  lane vector, node fetches become XLA gathers, and the three
  node kinds (internal / instance-leaf / triangle-leaf) are evaluated
  masked-parallel instead of branching.
* TLAS and BLAS nodes are merged into ONE node pool (TLAS at [0, K),
  every BLAS node at K + i), so the two-level structure needs no nested
  loop: an instance leaf simply swaps the ray into object space and jumps
  to the instance's BLAS root, and the LIFO stack discipline guarantees all
  stacked BLAS entries belong to the current instance.
* Stacks are a fixed (R, depth) register file; no dynamic allocation.

The quantized 4-wide restart-trail traversal (rt_unit parity) lives in
``ops.traverse_wide``; this binary version is the raycast-app analog and the
cross-check for it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from vortex_rt_tpu.models.scene import SceneBuffers
from vortex_rt_tpu.ops.intersect import (
    moller_trumbore, ray_aabb, safe_rcp, transform_ray,
)
from vortex_rt_tpu.utils.config import LARGE_FLOAT

# node kinds in the merged pool
KIND_INTERNAL = 0
KIND_INSTANCE = 1  # TLAS leaf -> enter a BLAS
KIND_TRIS = 2      # BLAS leaf -> intersect triangles
_POP = -1          # sentinel node id: pop the stack / terminate


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TraversalArrays:
    """Merged TLAS+BLAS node pool + leaf payloads, device-ready."""

    nmin: jnp.ndarray       # (K+N, 3)
    nmax: jnp.ndarray       # (K+N, 3)
    left: jnp.ndarray       # (K+N,) i32: child / instance id / first tri slot
    count: jnp.ndarray      # (K+N,) i32: tri count for KIND_TRIS
    kind: jnp.ndarray       # (K+N,) i32
    tri_idx: jnp.ndarray    # (T,) i32 leaf-slot -> global tri id
    v0: jnp.ndarray; v1: jnp.ndarray; v2: jnp.ndarray  # (T, 3)
    inst_inv: jnp.ndarray   # (I, 4, 4)
    inst_root: jnp.ndarray  # (I,) i32 merged-pool BLAS root
    inst_refl: jnp.ndarray  # (I,)
    max_leaf_tris: int = dataclasses.field(metadata=dict(static=True))
    num_tlas: int = dataclasses.field(metadata=dict(static=True))

    @staticmethod
    def from_scene(sb: SceneBuffers) -> "TraversalArrays":
        k = sb.tlas_min.shape[0]
        # --- TLAS part ---
        t_kind = np.where(sb.tlas_count > 0, KIND_INSTANCE, KIND_INTERNAL)
        # internal: left child tlas index; leaf: the single instance id
        t_left = np.where(
            sb.tlas_count > 0,
            sb.tlas_inst_idx[np.minimum(sb.tlas_left,
                                        sb.tlas_inst_idx.shape[0] - 1)],
            sb.tlas_left,
        ).astype(np.int32)
        t_count = np.zeros_like(sb.tlas_count)
        # --- BLAS part (children rebased by +k) ---
        b_internal = sb.bvh_count == 0
        b_kind = np.where(b_internal, KIND_INTERNAL, KIND_TRIS)
        b_left = np.where(b_internal, sb.bvh_left + k, sb.bvh_left).astype(np.int32)
        max_leaf = int(sb.bvh_count.max())
        return TraversalArrays(
            nmin=jnp.asarray(np.concatenate([sb.tlas_min, sb.bvh_min])),
            nmax=jnp.asarray(np.concatenate([sb.tlas_max, sb.bvh_max])),
            left=jnp.asarray(np.concatenate([t_left, b_left])),
            count=jnp.asarray(np.concatenate([t_count, sb.bvh_count])
                              .astype(np.int32)),
            kind=jnp.asarray(np.concatenate([t_kind, b_kind]).astype(np.int32)),
            tri_idx=jnp.asarray(sb.bvh_tri_idx),
            v0=jnp.asarray(sb.v0), v1=jnp.asarray(sb.v1), v2=jnp.asarray(sb.v2),
            inst_inv=jnp.asarray(sb.inst_inv_transform),
            inst_root=jnp.asarray((sb.inst_bvh_root
                                   + np.int32(k)).astype(np.int32)),
            inst_refl=jnp.asarray(sb.inst_reflectivity),
            max_leaf_tris=max_leaf,
            num_tlas=int(k),
        )


class Hits(NamedTuple):
    """ray_hit_t analog (common.h:48-54) as SoA lanes."""

    dist: jnp.ndarray  # (R,) LARGE_FLOAT = miss
    bx: jnp.ndarray
    by: jnp.ndarray
    bz: jnp.ndarray
    tri: jnp.ndarray   # (R,) i32 global triangle id
    inst: jnp.ndarray  # (R,) i32 instance (blasIdx analog)


class PerfCounters(NamedTuple):
    """MPM-style observability (rtu perf counter analog, core.h:73-90)."""

    nodes_visited: jnp.ndarray  # (R,) i32
    tri_tests: jnp.ndarray      # (R,) i32
    steps: jnp.ndarray          # () i32 lockstep iterations


class _State(NamedTuple):
    node: jnp.ndarray     # (R,) i32 current merged node or _POP
    stack: jnp.ndarray    # (R, D) i32
    sp: jnp.ndarray       # (R,) i32
    inst: jnp.ndarray     # (R,) i32 current instance
    lo: jnp.ndarray       # (R, 3) object-space origin
    ld: jnp.ndarray       # (R, 3) object-space direction (unnormalized)
    linv: jnp.ndarray     # (R, 3) 1 / ld
    best_t: jnp.ndarray
    bx: jnp.ndarray
    by: jnp.ndarray
    tri: jnp.ndarray
    best_inst: jnp.ndarray
    done: jnp.ndarray     # (R,) bool
    nodes_visited: jnp.ndarray
    tri_tests: jnp.ndarray
    steps: jnp.ndarray


def trace_rays(ta: TraversalArrays, o: jnp.ndarray, d: jnp.ndarray,
               stack_depth: int = 64, max_steps: int = 200_000,
               t_max: float = LARGE_FLOAT):
    """Closest-hit trace of a ray batch.  o, d: (R, 3) world space.

    Returns (Hits, PerfCounters).  jit-safe: fixed shapes, one while_loop.
    """
    r = o.shape[0]
    k = ta.nmin.shape[0]  # merged pool size (for clamping only)
    inv_d = safe_rcp(d)

    init = _State(
        node=jnp.zeros(r, jnp.int32),  # TLAS root is merged node 0
        stack=jnp.zeros((r, stack_depth), jnp.int32),
        sp=jnp.zeros(r, jnp.int32),
        inst=jnp.zeros(r, jnp.int32),
        lo=o, ld=d, linv=inv_d,
        best_t=jnp.full(r, t_max, jnp.float32),
        bx=jnp.zeros(r, jnp.float32),
        by=jnp.zeros(r, jnp.float32),
        tri=jnp.zeros(r, jnp.int32),
        best_inst=jnp.zeros(r, jnp.int32),
        done=jnp.zeros(r, bool),
        nodes_visited=jnp.zeros(r, jnp.int32),
        tri_tests=jnp.zeros(r, jnp.int32),
        steps=jnp.int32(0),
    )

    lanes = jnp.arange(r)
    num_pool = int(ta.kind.shape[0])
    num_tlas = ta.num_tlas

    def cond(s: _State):
        return jnp.logical_and(~jnp.all(s.done), s.steps < max_steps)

    def body(s: _State) -> _State:
        active = ~s.done
        node = jnp.clip(s.node, 0, ta.kind.shape[0] - 1)
        kind = ta.kind[node]
        is_int = active & (kind == KIND_INTERNAL)
        is_inst = active & (kind == KIND_INSTANCE)
        is_tris = active & (kind == KIND_TRIS)

        # ray coordinates: TLAS nodes (and their children fetch below) use
        # world space; BLAS nodes use the current object-space ray
        in_tlas = node < num_tlas
        ro = jnp.where(in_tlas[:, None], o, s.lo)
        rinv = jnp.where(in_tlas[:, None], inv_d, s.linv)

        # ---- internal: test both children, closest-first ----
        l = jnp.clip(ta.left[node], 0, num_pool - 2)
        rgt = l + 1
        tl, hl = ray_aabb(ro, rinv, ta.nmin[l], ta.nmax[l])
        tr, hr = ray_aabb(ro, rinv, ta.nmin[rgt], ta.nmax[rgt])
        # non-strict prune so exact-tie hits (flat boxes touching best_t)
        # still get tested and the deterministic tie-break below applies
        hl = hl & (tl <= s.best_t)
        hr = hr & (tr <= s.best_t)
        l_first = tl <= tr
        near = jnp.where(l_first, l, rgt)
        far = jnp.where(l_first, rgt, l)
        both = hl & hr
        next_int = jnp.where(both, near, jnp.where(hl, l, jnp.where(hr, rgt, _POP)))

        # push far child where both children hit
        push = is_int & both
        sp_clamped = jnp.minimum(s.sp, stack_depth - 1)
        stack = s.stack.at[lanes, sp_clamped].set(
            jnp.where(push, far, s.stack[lanes, sp_clamped])
        )
        sp = s.sp + push.astype(jnp.int32)

        # ---- instance leaf: swap into object space, jump to BLAS root ----
        iid = jnp.clip(ta.left[node], 0, ta.inst_root.shape[0] - 1)
        inv_t = ta.inst_inv[iid]
        lo_new, ld_new = transform_ray(inv_t, o, d)
        enter = is_inst
        inst = jnp.where(enter, iid, s.inst)
        lo = jnp.where(enter[:, None], lo_new, s.lo)
        ld = jnp.where(enter[:, None], ld_new, s.ld)
        linv = jnp.where(enter[:, None], safe_rcp(ld_new), s.linv)
        next_inst = ta.inst_root[iid]

        # ---- triangle leaf: up to max_leaf_tris MT tests ----
        lcount = ta.count[node]
        slots = ta.left[node][:, None] + jnp.arange(ta.max_leaf_tris)[None, :]
        slots = jnp.clip(slots, 0, ta.tri_idx.shape[0] - 1)
        tids = ta.tri_idx[slots]                      # (R, L)
        valid = jnp.arange(ta.max_leaf_tris)[None, :] < lcount[:, None]
        t, w1, w2 = moller_trumbore(
            lo[:, None, :], ld[:, None, :],
            ta.v0[tids], ta.v1[tids], ta.v2[tids],
        )
        t = jnp.where(valid & is_tris[:, None], t, LARGE_FLOAT)
        # deterministic tie-break: among equal-t hits pick the smallest
        # global tri id (and below, the smallest instance), so results are
        # bit-stable and match the brute-force oracle's iteration order
        t_min = t.min(axis=1)
        tid_key = jnp.where(t == t_min[:, None], tids, jnp.int32(2**31 - 1))
        j = jnp.argmin(tid_key, axis=1)
        t_best = t[lanes, j]
        closer = t_best < s.best_t
        tie = (t_best == s.best_t) & (t_best < LARGE_FLOAT)
        tie_better = tie & (
            (inst < s.best_inst)
            | ((inst == s.best_inst) & (tids[lanes, j] < s.tri))
        )
        upd = closer | tie_better
        best_t = jnp.where(upd, t_best, s.best_t)
        bx = jnp.where(upd, w1[lanes, j], s.bx)
        by = jnp.where(upd, w2[lanes, j], s.by)
        tri = jnp.where(upd, tids[lanes, j], s.tri)
        best_inst = jnp.where(upd, inst, s.best_inst)

        # ---- choose next node, then pop where requested ----
        nxt = jnp.where(
            is_int, next_int,
            jnp.where(is_inst, next_inst, jnp.full_like(s.node, _POP)),
        )
        nxt = jnp.where(active, nxt, s.node)
        want_pop = active & (nxt == _POP)
        can_pop = want_pop & (sp > 0)
        sp_top = jnp.maximum(sp - 1, 0)
        popped = stack[lanes, sp_top]
        nxt = jnp.where(can_pop, popped, nxt)
        sp = jnp.where(can_pop, sp_top, sp)
        done = s.done | (want_pop & ~can_pop)

        return _State(
            node=nxt, stack=stack, sp=sp, inst=inst, lo=lo, ld=ld, linv=linv,
            best_t=best_t, bx=bx, by=by, tri=tri, best_inst=best_inst,
            done=done,
            nodes_visited=s.nodes_visited + active.astype(jnp.int32),
            tri_tests=s.tri_tests
            + jnp.where(is_tris, lcount, 0).astype(jnp.int32),
            steps=s.steps + 1,
        )

    final = jax.lax.while_loop(cond, body, init)
    hits = Hits(
        dist=final.best_t,
        bx=final.bx, by=final.by, bz=1.0 - final.bx - final.by,
        tri=final.tri, inst=final.best_inst,
    )
    perf = PerfCounters(final.nodes_visited, final.tri_tests, final.steps)
    return hits, perf
