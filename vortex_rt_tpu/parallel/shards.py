"""Scene-sharded multi-chip rendering — the "sp" axis (>HBM scenes).

Implements docs/SCENE_SHARDING.md steps 1-3: instance-granular BLAS
sharding over a 2-D ``(dp, sp)`` device mesh.  Each chip holds

* its image row block's rays (``dp`` axis, as parallel.tiles), and
* ONE scene shard (``sp`` axis): the wide TLAS over its OWNED instances
  plus those instances' BLAS subtrees and packed leaf rows — the memory
  that dominates scene cost (nodes + tri_rows; the design doc's table).

TWO sp-axis schedules ship (``make_sharded_wavefront(schedule=...)``):

* ``"replicate"`` (default): rays are replicated across ``sp`` (each sp
  peer generates the same row-block rays arithmetically — zero
  communication), every peer traces its local sub-scene with the
  unmodified packet engine, and the per-ray closest hits are combined
  with a lexicographic (t, inst, tri) min over the ``sp`` axis — 3
  ``pmin`` + 4 ``psum`` collectives of slab-sized lanes per wave.
  Occlusion (shadow) waves combine with a single ``pmin``.
* ``"alltoall"``: the design doc's candidate-routed ray-exchange
  schedule (docs/SCENE_SHARDING.md steps 1-6) — each ray visits only
  the shards its TLAS candidates touch, near-to-far, exchanged with
  real ``lax.all_to_all`` collectives and pruned by best_t between
  waves.  Measured (the doc's accounting section): ~0.66-0.75x the
  replicate schedule's live-ray loop residency at sp=4; the margin
  grows with sp and per-shard tree depth, so this is the
  beyond-one-device-memory / many-sp schedule while replicate stays the
  communication-minimal default.

Correctness: instances are partitioned (each owned by exactly one
shard), so a hit (t, inst, tri) exists on exactly one peer and the
lexicographic min reproduces the single-chip engine's deterministic
tie-break exactly; shading happens on the ray's home chip with global
ids (materials/shade tables replicated — the doc's v1; shard-owned
shading is the v2 extension).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from vortex_rt_tpu.accel import qbvh
from vortex_rt_tpu.engine.megakernel import CameraArrays, LightArrays
from vortex_rt_tpu.models.scene import (
    Camera, RenderParams, Scene, SceneBuffers,
)
from vortex_rt_tpu.ops.traverse_wide import _LEFT_BITS, _LEFT_MASK, WideArrays
from vortex_rt_tpu.utils.config import LARGE_FLOAT

_I32MAX = np.int32(2**31 - 1)


def bin_pack_instances(scene: Scene, n_shards: int) -> List[List[int]]:
    """Greedy argmin-load bin-pack of instances by BLAS size (triangle
    count as the node-bytes proxy — nodes and leaf rows both scale with
    it).  Returns per-shard GLOBAL instance-id lists, each ascending (the
    in-shard order must preserve the global order so the packet engine's
    local tie-break agrees with the global one)."""
    insts = scene._instances
    assert len(insts) >= n_shards, (
        f"need >= {n_shards} instances to fill {n_shards} shards")
    weights = [scene._meshes[mi].num_tris for (mi, _, _) in insts]
    order = np.argsort(-np.asarray(weights), kind="stable")
    load = np.zeros(n_shards, np.int64)
    owner = np.zeros(len(insts), np.int32)
    for i in order:
        s = int(load.argmin())
        owner[i] = s
        load[s] += weights[i]
    return [sorted(int(i) for i in np.nonzero(owner == s)[0])
            for s in range(n_shards)]


def _pad_tlas_region(nodes: np.ndarray, k_old: int, k_new: int) -> np.ndarray:
    """Grow the TLAS region of a packed node pool from ``k_old`` to
    ``k_new`` rows so every shard shares one static ``num_tlas``.  BLAS
    internal links and instance BLAS-root words shift by the pad; the pad
    rows are unreachable zero-count KIND_TRIS leaves."""
    pad = k_new - k_old
    if pad == 0:
        return nodes
    nodes = nodes.copy()
    n = nodes.shape[0]
    meta = nodes[:, 14]
    kind = meta >> 29
    left = (meta & _LEFT_MASK).astype(np.int64)
    nch = (meta >> _LEFT_BITS) & 7
    blas_int = (kind == qbvh.KIND_INTERNAL) & (np.arange(n) >= k_old)
    left = np.where(blas_int, left + pad, left)
    nodes[:, 14] = (left.astype(np.uint32) | (nch << _LEFT_BITS)
                    | (kind << 29))
    is_inst = kind == qbvh.KIND_INSTANCE
    roots = nodes[is_inst, 28].view(np.int32) + pad
    nodes[is_inst, 28] = roots.view(np.uint32)
    dead = np.zeros((pad, 32), np.uint32)
    dead[:, 14] = np.uint32(qbvh.KIND_TRIS) << 29  # count 0, never reached
    return np.concatenate([nodes[:k_old], dead, nodes[k_old:]])


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ShardedArrays:
    """Stacked per-shard traversal pools (leading axis = sp shard)."""

    nodes: jnp.ndarray      # (S, Nmax, 32) u32
    tri_rows: jnp.ndarray   # (S, Lmax, 16*lmax) f32
    inst_map: jnp.ndarray   # (S, Imax) i32 local->global instance id
    # replicated TLAS-candidate routing tables (the all_to_all schedule,
    # docs/SCENE_SHARDING.md steps 1-2): world AABB + owner shard per
    # GLOBAL instance
    inst_aabb: jnp.ndarray  # (I, 6) f32 world lo.xyz, hi.xyz
    inst_owner: jnp.ndarray  # (I,) i32 owner shard id
    num_tlas: int = dataclasses.field(metadata=dict(static=True))
    max_leaf_tris: int = dataclasses.field(metadata=dict(static=True))
    depth: int = dataclasses.field(metadata=dict(static=True))

    def local(self, squeeze) -> Tuple[WideArrays, jnp.ndarray]:
        """Device-local (WideArrays, inst_map) inside shard_map (the
        leading shard axis arrives sliced to 1)."""
        return WideArrays(
            nodes=squeeze(self.nodes), tri_rows=squeeze(self.tri_rows),
            num_tlas=self.num_tlas, max_leaf_tris=self.max_leaf_tris,
            depth=self.depth), squeeze(self.inst_map)

    def specs(self, sp_axis: str = "sp") -> "ShardedArrays":
        """shard_map in_specs tree: pools shard over sp, the routing
        tables (inst_aabb/inst_owner) replicate."""
        return ShardedArrays(
            nodes=P(sp_axis), tri_rows=P(sp_axis), inst_map=P(sp_axis),
            inst_aabb=P(), inst_owner=P(),
            num_tlas=self.num_tlas, max_leaf_tris=self.max_leaf_tris,
            depth=self.depth)

    def bytes_per_shard(self) -> int:
        """Per-chip resident scene bytes under P(sp) sharding: each chip
        holds ONE row of the stacked pools (the padded shard — padding
        rows are the price of a static shape).  This is the number the
        >HBM motivation needs to beat (docs/SCENE_SHARDING.md)."""
        return int(self.nodes.shape[1] * self.nodes.shape[2] * 4
                   + self.tri_rows.shape[1] * self.tri_rows.shape[2] * 4
                   + self.inst_map.shape[1] * 4)


def memory_table(sharded: ShardedArrays, sb_full: SceneBuffers) -> dict:
    """Replicated-vs-sharded per-chip scene-memory accounting (the
    design doc's >HBM demonstration, docs/SCENE_SHARDING.md).  Returns
    bytes: 'replicated' (full WideArrays per chip), 'sharded_per_chip'
    (one padded shard), and their ratio."""
    wa_full = WideArrays.from_scene(sb_full)
    replicated = int(np.asarray(wa_full.nodes).nbytes
                     + np.asarray(wa_full.tri_rows).nbytes)
    per_chip = sharded.bytes_per_shard()
    return {
        "replicated_bytes": replicated,
        "sharded_per_chip_bytes": per_chip,
        "n_shards": int(sharded.nodes.shape[0]),
        "ratio": per_chip / max(replicated, 1),
    }


def build_sharded(scene: Scene, n_shards: int,
                  config=None) -> Tuple[ShardedArrays, SceneBuffers]:
    """Step 1 (design doc): build-time bin-pack + per-shard packing.

    Returns (ShardedArrays, full SceneBuffers).  The full buffers feed
    the replicated shading tables and the golden oracle; each shard's
    node/leaf pool covers only its owned instances.  Per-shard sub-scenes
    re-add ALL meshes (so the packed leaf rows keep GLOBAL triangle ids —
    Scene.build packs every mesh into the global pools) but only owned
    instances (so the wide pool only collapses owned BLAS roots)."""
    shards = bin_pack_instances(scene, n_shards)
    sb_full = scene.build(config)

    # replicated routing tables: world AABB (8 transformed mesh-AABB
    # corners, bvh.cpp:291-314) + owner shard per global instance
    n_inst_g = len(scene._instances)
    inst_aabb = np.zeros((n_inst_g, 6), np.float32)
    inst_owner = np.zeros(n_inst_g, np.int32)
    for s, owned in enumerate(shards):
        for gi in owned:
            inst_owner[gi] = s
    for gi, (mi, tf, _) in enumerate(scene._instances):
        lo, hi = scene._meshes[mi].aabb()
        corners = np.array([[x, y, z, 1.0]
                            for x in (lo[0], hi[0])
                            for y in (lo[1], hi[1])
                            for z in (lo[2], hi[2])], np.float32)
        wc = corners @ np.asarray(tf, np.float32).T
        inst_aabb[gi, :3] = wc[:, :3].min(0)
        inst_aabb[gi, 3:] = wc[:, :3].max(0)

    nodes_l, rows_l, imap_l = [], [], []
    num_tlas, max_leaf, depth = 0, 1, 0
    was = []
    for owned in shards:
        sub = Scene()
        for m in scene._meshes:
            sub.add_mesh(m)
        for gi in owned:
            mi, tf, refl = scene._instances[gi]
            sub.add_instance(mi, tf, refl)
        wa = WideArrays.from_scene(sub.build(config))
        was.append(wa)
        num_tlas = max(num_tlas, wa.num_tlas)
        max_leaf = max(max_leaf, wa.max_leaf_tris)
        depth = max(depth, wa.depth)
        imap_l.append(np.asarray(owned, np.int32))

    for wa in was:
        nodes_l.append(_pad_tlas_region(np.asarray(wa.nodes),
                                        wa.num_tlas, num_tlas))
        rows = np.asarray(wa.tri_rows)
        if wa.max_leaf_tris < max_leaf:
            rows = np.concatenate(
                [rows, np.zeros((rows.shape[0],
                                 16 * (max_leaf - wa.max_leaf_tris)),
                                np.float32)], axis=1)
        rows_l.append(rows)

    def stack_pad(arrs, fill=0):
        nmax = max(a.shape[0] for a in arrs)
        out = np.full((len(arrs), nmax) + arrs[0].shape[1:], fill,
                      arrs[0].dtype)
        for i, a in enumerate(arrs):
            out[i, :a.shape[0]] = a
        return out

    return ShardedArrays(
        nodes=jnp.asarray(stack_pad(nodes_l)),
        tri_rows=jnp.asarray(stack_pad(rows_l)),
        inst_map=jnp.asarray(stack_pad(imap_l)),
        inst_aabb=jnp.asarray(inst_aabb),
        inst_owner=jnp.asarray(inst_owner),
        num_tlas=num_tlas, max_leaf_tris=max_leaf, depth=depth,
    ), sb_full


def make_sharded_wavefront(mesh: Mesh, width: int, height: int,
                           max_depth: int = 2, spp: int = 1,
                           chunk: int = 512, shadow: bool = False,
                           pathtrace: bool = False, packet: int = 128,
                           tile_w: int = 16, tile_h: int = 8,
                           dp_axis: str = "dp", sp_axis: str = "sp",
                           schedule: str = "replicate",
                           accounting: bool = False):
    """Step 2 (design doc): the jitted SPMD step over the (dp, sp) mesh.

    step(sharded, sa, cam, light) -> ((H, W, 3) image, total rays,
    total traversal steps).

    ``schedule`` selects the sp-axis traversal schedule:

    * ``"replicate"`` (default) — replicate-rays: every sp peer traces
      every ray against its local shard; one lexicographic pmin/psum
      combine per wave.  Communication-minimal, traversal compute x sp.
    * ``"alltoall"`` — the candidate-routed ray-exchange schedule
      (docs/SCENE_SHARDING.md steps 1-6): each ray's TLAS candidates
      (dense ray-vs-instance-AABB slab tests against the replicated
      instance table) are grouped by owner shard and visited
      near-to-far; instance wave k sends each ray to its k-th candidate
      owner with ONE ``lax.all_to_all``, the owner traces the rays it
      received against its local shard (unmodified packet engine), a
      reverse ``all_to_all`` returns (t, bary, global ids), and the
      per-ray lexicographic min over waves updates best_t — which
      PRUNES later waves (a ray whose best hit is closer than its next
      owner's nearest candidate-box entry drops out, the same early-out
      the single-chip ordered TLAS descent gets).  Traversal compute no
      longer scales with sp: summed across the mesh, each ray is traced
      only on the shards its candidates actually touch (the accounting
      test gates sum-of-steps vs the replicate schedule's x sp).

    ``accounting=True`` switches the returned step count from loop
    iterations to PacketStats.ray_steps — live rays per loop iteration,
    summed.  That is the compute figure the two schedules are honestly
    compared on: loop ITERATION counts charge a mostly-dead wave the
    same as a full one, and live PACKET counts quantize harshly at
    small test scales (a 10-ray wave still walks one whole packet);
    live-ray residency is packet-size-invariant and proportional to
    the lane-iterations the mesh actually spends."""
    from vortex_rt_tpu.engine.shaders import ShaderTable, pathtrace_closest
    from vortex_rt_tpu.engine.wavefront import frame_body
    from vortex_rt_tpu.ops.traverse_packet import trace_packets

    n_dp = mesh.shape[dp_axis]
    n_sp = mesh.shape[sp_axis]
    assert height % n_dp == 0, f"height {height} % {n_dp} devices != 0"
    assert schedule in ("replicate", "alltoall")
    rows_local = height // n_dp
    n_pix_local = rows_local * width
    table = (ShaderTable(closest=pathtrace_closest) if pathtrace
             else ShaderTable())

    def _body(sharded: ShardedArrays, sa, cam, light):
        wa_local, inst_map = sharded.local(lambda a: a[0])
        n_inst = inst_map.shape[0]

        def trace_replicate(ox, oy, oz, dx, dy, dz, act, t_clamp, occl):
            r = ox.shape[0]
            o3 = jnp.stack([ox, oy, oz], axis=1)
            d3 = jnp.stack([dx, dy, dz], axis=1)
            tc = jnp.full(r, LARGE_FLOAT) if t_clamp is None else t_clamp
            h, st = trace_packets(wa_local, o3, d3, packet=packet,
                                  active=act, t_max=tc, occlusion=occl,
                                  stats=accounting)
            if accounting:
                st = st.ray_steps.astype(jnp.int32)
            steps = jax.lax.psum(st, sp_axis)
            if occl:
                # occluded lanes report 0.0 < t_max; any shard occludes
                return (jax.lax.pmin(h.dist, sp_axis), h.bx, h.by,
                        h.tri, h.inst, steps)
            ginst = inst_map[jnp.clip(h.inst, 0, n_inst - 1)]
            # lexicographic (t, global inst, tri) min across shards —
            # exactly one peer holds each (inst, tri), so the psum
            # broadcast of the winner's fields is exact
            tmin = jax.lax.pmin(h.dist, sp_axis)
            is_hit = tmin < LARGE_FLOAT
            on_min = (h.dist == tmin) & is_hit
            imin = jax.lax.pmin(
                jnp.where(on_min, ginst, _I32MAX), sp_axis)
            on_min = on_min & (ginst == imin)
            trimin = jax.lax.pmin(
                jnp.where(on_min, h.tri, _I32MAX), sp_axis)
            win = on_min & (h.tri == trimin)
            bx = jax.lax.psum(jnp.where(win, h.bx, 0.0), sp_axis)
            by = jax.lax.psum(jnp.where(win, h.by, 0.0), sp_axis)
            return (jnp.where(is_hit, tmin, LARGE_FLOAT), bx, by,
                    jnp.where(is_hit, trimin, 0),
                    jnp.where(is_hit, imin, 0), steps)

        def trace_alltoall(ox, oy, oz, dx, dy, dz, act, t_clamp, occl):
            r = ox.shape[0]
            S = n_sp
            tc = jnp.full(r, LARGE_FLOAT) if t_clamp is None else t_clamp

            # ---- step 1: TLAS-candidate owner ranking (replicated
            # instance AABBs; dense (I, R) slab tests — I is small) ----
            lo = sharded.inst_aabb[:, :3]
            hi = sharded.inst_aabb[:, 3:]

            def rcp(v):
                return 1.0 / jnp.where(jnp.abs(v) < 1e-20,
                                       jnp.where(v < 0, -1e-20, 1e-20), v)

            ivx, ivy, ivz = rcp(dx), rcp(dy), rcp(dz)
            t1x = (lo[:, 0:1] - ox[None]) * ivx[None]
            t2x = (hi[:, 0:1] - ox[None]) * ivx[None]
            t1y = (lo[:, 1:2] - oy[None]) * ivy[None]
            t2y = (hi[:, 1:2] - oy[None]) * ivy[None]
            t1z = (lo[:, 2:3] - oz[None]) * ivz[None]
            t2z = (hi[:, 2:3] - oz[None]) * ivz[None]
            tmin_i = jnp.maximum(
                jnp.maximum(jnp.minimum(t1x, t2x), jnp.minimum(t1y, t2y)),
                jnp.minimum(t1z, t2z))
            tmax_i = jnp.minimum(
                jnp.minimum(jnp.maximum(t1x, t2x), jnp.maximum(t1y, t2y)),
                jnp.maximum(t1z, t2z))
            cand = ((tmax_i >= tmin_i) & (tmax_i > 0.0)
                    & (tmin_i < tc[None]) & act[None])       # (I, R)
            enter = jnp.where(cand, jnp.maximum(tmin_i, 0.0),
                              LARGE_FLOAT)
            # nearest candidate entry per OWNER shard (S, R)
            d_owner = jnp.stack([
                jnp.min(jnp.where((sharded.inst_owner == s)[:, None],
                                  enter, LARGE_FLOAT), axis=0)
                for s in range(S)])
            # near-to-far owner visit order per ray
            d_sorted, owner_sorted = jax.lax.sort(
                (d_owner,
                 jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[:, None],
                                  (S, r))),
                dimension=0, is_stable=True, num_keys=1)

            best_t = jnp.full(r, LARGE_FLOAT)
            best_i = jnp.full(r, _I32MAX)
            best_tri = jnp.full(r, _I32MAX)
            best_bx = jnp.zeros(r)
            best_by = jnp.zeros(r)
            occluded = jnp.zeros(r, bool)
            steps = jnp.int32(0)
            s_ids = jnp.arange(S, dtype=jnp.int32)[:, None]

            # ---- home slicing: rays are replicated across the sp
            # peers (regenerated arithmetically), so each peer must
            # route only a DISJOINT 1/S home slice — otherwise every
            # owner receives each ray S times and traces it S times
            # (measured: exactly the x2-3 packet-step inflation the
            # accounting test caught).  Homes are CONTIGUOUS lane
            # blocks, not lane % S interleaves: packets form over
            # consecutive live lanes after the receive-side compaction,
            # and interleaved homes put every 4th pixel in a packet —
            # ~4x the screen area per packet union (measured 1.2-1.3x
            # total residency, worse than replicate).  The final psum
            # below broadcasts each home's results to the other peers
            # (they shade identically, as in the replicate schedule).
            me = jax.lax.axis_index(sp_axis)
            lane = jnp.arange(r, dtype=jnp.int32)
            home = (lane * S) // r == me

            for k in range(S):
                dest = owner_sorted[k]                        # (R,)
                want = act & home & (d_sorted[k] < LARGE_FLOAT)
                # step 4's prune: a settled closest hit (or occlusion)
                # before this owner's nearest candidate box kills the
                # visit
                want = want & (d_sorted[k] < best_t) & ~occluded

                # ---- step 2: bin by owner + ONE all_to_all exchange.
                # Bin s = the full lane set masked to rays whose wave-k
                # owner is s (static capacity R: overflow impossible;
                # padding lanes carry act=0 and exit at the packet
                # engine's first compaction rounds) ----
                m = (dest[None] == s_ids) & want[None]        # (S, R)
                send = jnp.stack([
                    jnp.where(m, ox[None], 0.0),
                    jnp.where(m, oy[None], 0.0),
                    jnp.where(m, oz[None], 0.0),
                    jnp.where(m, dx[None], 0.0),
                    jnp.where(m, dy[None], 1.0),
                    jnp.where(m, dz[None], 0.0),
                    jnp.where(m, tc[None], -1.0),
                    m.astype(jnp.float32),
                ], axis=2)                                    # (S, R, 8)
                recv = jax.lax.all_to_all(send, sp_axis, 0, 0)

                # ---- step 3: the owner traces what it received with
                # the unmodified local packet engine.  Received live
                # rays are SPARSE over the (S, R) bin layout (each bin
                # is a masked full lane set), so they are compacted
                # live-first before packetization — otherwise nearly
                # every packet holds >= 1 live ray and walks a union for
                # a handful of lanes (hits are packet-composition-
                # independent: the engine's standing bit-identity
                # argument, rule 25/livesort) ----
                f = recv.reshape(S * r, 8)
                r_act = f[:, 7] > 0.5
                perm = jnp.argsort(~r_act)
                fp = f[perm]
                p_act = fp[:, 7] > 0.5
                h, st = trace_packets(
                    wa_local,
                    fp[:, 0:3], fp[:, 3:6], packet=packet,
                    active=p_act,
                    t_max=jnp.where(p_act, fp[:, 6], -1.0),
                    occlusion=occl, stats=accounting)
                if accounting:
                    st = st.ray_steps.astype(jnp.int32)
                steps = steps + st

                def unp(a):
                    return jnp.zeros_like(a).at[perm].set(a)

                ginst = inst_map[jnp.clip(h.inst, 0, n_inst - 1)]
                ret = jnp.stack([
                    unp(h.dist), unp(h.bx), unp(h.by),
                    unp(h.tri).astype(jnp.float32),
                    unp(ginst).astype(jnp.float32)],
                    axis=1).reshape(S, r, 5)

                # ---- reverse all_to_all: results return to the ray's
                # home chip; slot s holds my rays' hits from owner s —
                # select each ray's own destination's answer ----
                back = jax.lax.all_to_all(ret, sp_axis, 0, 0)  # (S, R, 5)
                mine = jnp.take_along_axis(
                    back,
                    jnp.broadcast_to(dest[None, :, None].astype(jnp.int32),
                                     (1, r, 5)), axis=0)[0]    # (R, 5)
                t_k = jnp.where(want, mine[:, 0], LARGE_FLOAT)
                if occl:
                    # owner reports 0.0 for occluded (first hit inside
                    # the clamp); any owner occluding settles the ray
                    occluded = occluded | (want & (t_k < tc))
                    continue
                i_k = mine[:, 4].astype(jnp.int32)
                tri_k = mine[:, 3].astype(jnp.int32)
                hit_k = t_k < LARGE_FLOAT
                better = (t_k < best_t) | (
                    (t_k == best_t) & hit_k
                    & ((i_k < best_i)
                       | ((i_k == best_i) & (tri_k < best_tri))))
                best_t = jnp.where(better, t_k, best_t)
                best_i = jnp.where(better, i_k, best_i)
                best_tri = jnp.where(better, tri_k, best_tri)
                best_bx = jnp.where(better, mine[:, 1], best_bx)
                best_by = jnp.where(better, mine[:, 2], best_by)

            steps = jax.lax.psum(steps, sp_axis)
            # broadcast each home slice's results to all sp peers
            # (exactly one home per ray, so the psum IS the home value)
            def from_home(x, neutral=0.0):
                return jax.lax.psum(
                    jnp.where(home, x, jnp.zeros_like(x)), sp_axis)

            if occl:
                occ_all = from_home(occluded.astype(jnp.int32)) > 0
                return (jnp.where(occ_all, 0.0, LARGE_FLOAT),
                        jnp.zeros(r), jnp.zeros(r),
                        jnp.zeros(r, jnp.int32), jnp.zeros(r, jnp.int32),
                        steps)
            is_hit = best_t < LARGE_FLOAT
            t_all = from_home(jnp.where(is_hit, best_t, 0.0))
            hit_all = from_home(is_hit.astype(jnp.int32)) > 0
            return (jnp.where(hit_all, t_all, LARGE_FLOAT),
                    from_home(best_bx), from_home(best_by),
                    from_home(jnp.where(is_hit, best_tri, 0)),
                    from_home(jnp.where(is_hit, best_i, 0)), steps)

        trace_fn = (trace_alltoall if schedule == "alltoall"
                    else trace_replicate)

        dev = jax.lax.axis_index(dp_axis)
        pix_offset = dev.astype(jnp.int32) * n_pix_local
        img, rays, steps = frame_body(
            sharded, sa, cam, light, width, height, n_pix_local,
            pix_offset, max_depth=max_depth, spp=spp, chunk=chunk,
            table=table, seed=0, packet=packet, shadow=shadow,
            tile_w=tile_w, tile_h=tile_h, trace_fn=trace_fn)
        total = jax.lax.psum(rays, dp_axis)
        # steps is already sp-summed inside the trace; sum the dp blocks
        steps_total = jax.lax.psum(steps, dp_axis)
        return (img.reshape(3, rows_local, width).transpose(1, 2, 0),
                total, steps_total)

    def step(sharded, sa, cam, light):
        shard = jax.shard_map(
            _body, mesh=mesh,
            in_specs=(
                sharded.specs(sp_axis),
                jax.tree.map(lambda _: P(), sa),
                jax.tree.map(lambda _: P(), cam),
                jax.tree.map(lambda _: P(), light)),
            out_specs=(P(dp_axis), P(), P()),
            check_vma=False,
        )
        return shard(sharded, sa, cam, light)

    return jax.jit(step)


def render_sharded(scene: Scene, cam: Camera, params: RenderParams,
                   width: int, height: int, n_shards: int,
                   mesh: Optional[Mesh] = None,
                   packet: int = 128, schedule: str = "replicate",
                   return_steps: bool = False, accounting: bool = False):
    """Host API: bin-pack + shard + render over an (dp, sp) mesh built
    from the available devices (dp = n_devices // n_shards).

    ``schedule``: 'replicate' or 'alltoall' (make_sharded_wavefront).
    ``return_steps=True`` additionally returns the mesh-summed traversal
    step count — the compute-accounting figure the two schedules are
    compared on (docs/SCENE_SHARDING.md)."""
    from vortex_rt_tpu.ops.shade_lanes import ShadeArrays

    sharded, sb_full = build_sharded(scene, n_shards)
    if mesh is None:
        devs = np.array(jax.devices())
        n_dp = len(devs) // n_shards
        mesh = Mesh(devs[: n_dp * n_shards].reshape(n_dp, n_shards),
                    ("dp", "sp"))
    step = make_sharded_wavefront(
        mesh, width, height, params.max_depth, params.spp,
        shadow=params.shadow,
        pathtrace=getattr(params, "pathtrace", False), packet=packet,
        schedule=schedule, accounting=accounting)
    img, total, steps = step(sharded, ShadeArrays.from_scene(sb_full),
                             CameraArrays.from_camera(cam),
                             LightArrays.from_params(params))
    if return_steps:
        return np.asarray(img), int(total), int(steps)
    return np.asarray(img), int(total)
