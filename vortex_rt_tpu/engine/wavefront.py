"""Wavefront render engine — the RT unit + shader-queue analog.

This is the flagship renderer.  The reference implements wavefront
scheduling in hardware: the RTU traverses rays, parks completions in
per-shader-type queues, and ``getWork`` repacks divergent continuations
into dense warps (rt_unit.cpp:98-161, the design's centerpiece — SURVEY.md
section 2.7 item 3).  The JAX equivalent:

* the ray pool IS the framebuffer-ordered SoA batch; one pool slot per
  (pixel, sample) carries the payload (ray_payload_t analog: throughput /
  bounce / pixel);
* traversal is a packet-engine while_loop per streamed slab of the pool
  (fewer, larger loops mean fewer loop iterations per frame);
* shader-queue regrouping is packet-granular and implicit: a packet whose
  rays are all dead exits its walk on the first iteration, and tile-major
  pool order keeps packets coherent.  Ray-level argsort compaction (the
  literal pop_warp analog) lives only in the host-orchestrated chunked
  path below (a full-pool argsort + gathers per bounce was chosen against
  for the fused frame);
* shaders are batch functions from the ShaderTable (engine.shaders); the
  miss/closest shaders of every ray in the wave run as two dense vector
  stages instead of per-warp indirect calls;
* any-hit, when registered, runs in the reference's suspension protocol:
  the chunk traversal pauses on each strictly-closer intersection, the
  any-hit batch shader produces CONT/ACCEPT/TERM actions, commit() applies
  them, traversal resumes (rt_unit ANY queue + commit, rt_unit.cpp:190-213).

The whole frame (spp samples x max_depth bounces) is ONE jit program; spp
is folded into the pool (R = w*h*spp) and resolved with a grouped reshape
at the end, so no Python-level loop scales with sample count.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vortex_rt_tpu.engine.megakernel import CameraArrays, LightArrays
from vortex_rt_tpu.engine.shaders import (
    PayloadLanes, RayLanes, ShaderContext, ShaderTable,
)
from vortex_rt_tpu.models.scene import (
    Camera, RenderParams, Scene, SceneBuffers,
)
from vortex_rt_tpu.ops.shade_lanes import ShadeArrays, shade_point
from vortex_rt_tpu.ops.traverse_packet import trace_packets
from vortex_rt_tpu.ops.traverse2 import Hits, PerfCounters
from vortex_rt_tpu.ops.traverse_wide import (
    WideArrays, commit, init_state_lanes, trace_lanes,
)
from vortex_rt_tpu.utils import sampling
from vortex_rt_tpu.utils.config import COMMIT_CONT, LARGE_FLOAT, RTConfig
from vortex_rt_tpu.utils.trace import maybe_span


def tile_pixel_perm(width: int, height: int, tile_w: int = 16,
                    tile_h: int = 8) -> Optional[np.ndarray]:
    """Pool-position -> image-pixel-id permutation that lays pixels out
    tile-major, so each 128-ray packet is a compact 16x8 pixel tile
    instead of a thin image row — the reference's 8x8 tile-to-core mapping
    (kernel.cpp:128-133) reborn as packet-coherence layout.  Returns None
    when the frame doesn't divide into tiles (callers fall back to
    row-major).

    NOTE: the production frame no longer gathers through this table — the
    same mapping is computed arithmetically per lane (``_tile_pixel_ids``),
    which needs no pool-scale gather.  Kept for tests and host-side
    tools."""
    if width % tile_w or height % tile_h:
        return None
    ty, tx = np.meshgrid(np.arange(height // tile_h),
                         np.arange(width // tile_w), indexing="ij")
    py, px = np.meshgrid(np.arange(tile_h), np.arange(tile_w), indexing="ij")
    # (tiles_y, tiles_x, tile_h, tile_w) -> flat pixel ids
    yy = ty[:, :, None, None] * tile_h + py[None, None]
    xx = tx[:, :, None, None] * tile_w + px[None, None]
    return (yy * width + xx).reshape(-1).astype(np.int32)


def _tile_pixel_ids(q: jnp.ndarray, width: int, tile_w: int, tile_h: int,
                    row0: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Tile-major pool-pixel index ``q`` -> (px, py) image coordinates,
    pure integer arithmetic (no gather).  ``row0`` offsets the block's
    first image row (multi-chip row blocks)."""
    lane_n = tile_w * tile_h
    t = q // lane_n
    l = q % lane_n
    ntx = width // tile_w
    tx = t % ntx
    ty = t // ntx
    px = tx * tile_w + l % tile_w
    py = row0 + ty * tile_h + l // tile_w
    return px, py


def _jitter(pix, samp, total_spp: int):
    """Per-sample sub-pixel offsets via the counter-based stratified
    sampler (utils.sampling — bit-identical under NumPy, so the golden
    path tracer replays the same rays).  The stochastic-sampling upgrade
    of GenerateRay's +0.5 center (raycast/render.h:190-208); total_spp==1
    keeps the reference's exact pixel-center rays for golden parity."""
    if total_spp == 1:
        return 0.5, 0.5
    return sampling.stratified_jitter(jnp, pix.astype(jnp.uint32), samp,
                                      total_spp, 0)


def _camera_from_pix(cam: CameraArrays, width: int, height: int,
                     pxi, pyi, pix, samp, total_spp: int):
    """Shared camera-ray math: integer pixel coords + sample id -> ray
    lanes (GenerateRay, raycast/render.h:190-208).  Everything is (R,)
    arithmetic on the inputs — no gathers, so callers may pass lanes for
    any pool subset (a full frame, a row block, or one slab)."""
    px = pxi.astype(jnp.float32)
    py = pyi.astype(jnp.float32)
    jx, jy = _jitter(pix, samp, total_spp)
    x_ndc = (px + jx) / width - 0.5
    y_ndc = (py + jy) / height - 0.5
    vx = x_ndc * cam.viewplane[0]
    vy = y_ndc * cam.viewplane[1]
    dx = vx * cam.right[0] + vy * cam.up[0] + cam.forward[0]
    dy = vx * cam.right[1] + vy * cam.up[1] + cam.forward[1]
    dz = vx * cam.right[2] + vy * cam.up[2] + cam.forward[2]
    inv = 1.0 / jnp.sqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * inv, dy * inv, dz * inv
    r = px.shape[0]
    ox = jnp.full(r, cam.pos[0])
    oy = jnp.full(r, cam.pos[1])
    oz = jnp.full(r, cam.pos[2])
    return ox, oy, oz, dx, dy, dz


def _camera_lanes(cam: CameraArrays, width: int, height: int, spp: int,
                  samp, total_spp: int, n_pix: int = None, pix_offset=0,
                  pix_perm: Optional[jnp.ndarray] = None
                  ) -> Tuple[jnp.ndarray, ...]:
    """Primary rays for the pool: R = n_pix*spp lanes, pixel-major (or
    permuted by ``pix_perm`` for tile-major packet coherence).

    ``pix_offset`` shifts the (row-major) pixel ids — used by the
    multi-chip tiled path where each device renders a row block.
    Sample 0 uses the reference's pixel center (+0.5); further samples are
    stratified-jittered (GenerateRay, raycast/render.h:190-208).
    """
    if n_pix is None:
        n_pix = width * height
    r = n_pix * spp
    base = jnp.arange(r, dtype=jnp.int32) // spp
    if pix_perm is not None:
        pix = pix_offset + pix_perm[base]
    else:
        pix = pix_offset + base
    ox, oy, oz, dx, dy, dz = _camera_from_pix(
        cam, width, height, pix % width, pix // width, pix, samp, total_spp)
    return ox, oy, oz, dx, dy, dz, pix


def _camera_lanes_tiled(cam: CameraArrays, width: int, height: int,
                        spp: int, samp, total_spp: int,
                        tile_w: int, tile_h: int,
                        n_pix: int, row0: int):
    """Primary rays in tile-major pool order, R = n_pix*spp lanes, pixel
    coordinates computed arithmetically (zero gathers — see
    ``tile_pixel_perm``).  Samples of one pixel are adjacent lanes, so a
    P-lane packet covers P/spp pixels of one tile (coherence improves with
    spp).  Requires width %% tile_w == 0 and (n_pix//width) %% tile_h == 0.
    """
    r = n_pix * spp
    q = jnp.arange(r, dtype=jnp.int32) // spp
    pxi, pyi = _tile_pixel_ids(q, width, tile_w, tile_h, row0)
    pix = pyi * width + pxi
    ox, oy, oz, dx, dy, dz = _camera_from_pix(
        cam, width, height, pxi, pyi, pix, samp, total_spp)
    return ox, oy, oz, dx, dy, dz, pix


def _resolve_tiled(lanes, width: int, rows: int, spp: int,
                   tile_w: int, tile_h: int) -> jnp.ndarray:
    """(n_pix*spp,) tile-major radiance lanes -> (rows, width) image.
    Pure reshape/mean/transpose — replaces an argsort+gather resolve."""
    nty, ntx = rows // tile_h, width // tile_w
    a = lanes.reshape(nty, ntx, tile_h, tile_w, spp).mean(-1)
    return a.transpose(0, 2, 1, 3).reshape(rows, width)


# live-first bounce-wave packetization (see _wave_pipeline): default-off
# staged knob pending hardware timing, like the rule-27 set
_LIVE_SORT_DEFAULT = os.environ.get("VORTEX_RT_LIVE_SORT", "0") == "1"


def _inline_alpha(table: ShaderTable, wa: WideArrays) -> Optional[float]:
    """Threshold of an in-loop-capable alpha-test any-hit, else None.

    alpha_test_anyhit marks its shader with ``alpha_threshold``; when the
    scene's WideArrays carry the with_alpha tables, the packet engine
    evaluates the test inside the traversal loop (trace_packets
    alpha_ref) — same accepted hits as the suspension protocol, none of
    its per-ray-engine cost.  Custom any-hit callables (no marker)
    return None and keep the suspension fallback."""
    thr = getattr(table.anyhit, "alpha_threshold", None)
    if thr is not None and wa.alpha_rows is not None:
        return float(thr)
    return None


def _inline_anyhit(table: ShaderTable, wa: WideArrays):
    """In-loop-capable any-hit predicate ``pred(u, v, alpha) -> keep``,
    else None.

    Two shader markers qualify (both need the scene's with_alpha
    tables): ``alpha_threshold`` (alpha_test_anyhit — the predicate is
    the alpha compare) and ``inline_predicate`` (stateless_anyhit — an
    arbitrary stateless per-candidate predicate).  Unmarked any-hit
    callables return None and keep the per-ray suspension fallback
    (they may be stateful; rt_unit.cpp:190-213 generality)."""
    if getattr(wa, "alpha_rows", None) is None:
        # no tables (or a ShardedArrays stack, which has none)
        return None
    pred = getattr(table.anyhit, "inline_predicate", None)
    if pred is not None:
        return pred
    thr = getattr(table.anyhit, "alpha_threshold", None)
    if thr is not None:
        thr_f = jnp.float32(thr)

        def pred(u, v, a, _t=thr_f):  # noqa: ARG001
            return ~(a < _t)

        return pred
    return None


def _trace_pool(wa: WideArrays, sa: ShadeArrays, ctx: ShaderContext,
                table: ShaderTable, lanes, alive, payload, chunk: int,
                t_clamp=None):
    """Trace every pool ray in `chunk`-sized pieces (lax.map).

    Dead lanes get a degenerate no-op trace (t_max<=0 kills the root test
    immediately), so fully-dead chunks exit their while_loop in one step.
    ``t_clamp`` (R,) bounds each ray's search interval (shadow rays).
    Returns hit lanes (dist/bx/by/bz/tri/inst) and total steps.
    """
    ox, oy, oz, dx, dy, dz = lanes
    r = ox.shape[0]
    c = r // chunk
    clamp = jnp.full(r, LARGE_FLOAT) if t_clamp is None else t_clamp

    def chunk_body(args):
        (cox, coy, coz, cdx, cdy, cdz, calive, cthr, cbounce, cpix,
         csamp, cclamp) = args
        t_max = jnp.where(calive, cclamp, -1.0)
        st = init_state_lanes(cox, coy, coz, cdx, cdy, cdz)
        st = st._replace(best_t=t_max, done=~calive)
        if table.anyhit is None:
            hits, st, perf = trace_lanes(
                wa, cox, coy, coz, cdx, cdy, cdz, state=st)
        else:
            def cond(s):
                return jnp.any(~s.done)

            def body(s):
                _, s, _ = trace_lanes(wa, cox, coy, coz, cdx, cdy, cdz,
                                      state=s, suspend=True)
                sp = shade_point(
                    sa, cox, coy, coz, cdx, cdy, cdz,
                    s.pend_t, s.pend_bx, s.pend_by,
                    1.0 - s.pend_bx - s.pend_by,
                    jnp.clip(s.pend_tri, 0, sa.shade_rows.shape[0] - 1),
                    jnp.clip(s.pend_inst, 0, sa.inst_shade.shape[0] - 1))
                ray = RayLanes(cox, coy, coz, cdx, cdy, cdz)
                pl = PayloadLanes(cthr, cbounce, cpix, csamp)
                action = table.anyhit(ctx, sp, ray, pl)
                s = commit(s, jnp.where(s.suspended, action, COMMIT_CONT))
                return s

            st = jax.lax.while_loop(cond, body, st)
            hits = Hits(dist=st.best_t, bx=st.bx, by=st.by,
                        bz=1.0 - st.bx - st.by, tri=st.tri,
                        inst=st.best_inst)
            # perf counters survive suspension: the while carries them in
            # the state (VERDICT r1 weak #5)
            perf = PerfCounters(st.nodes_visited, st.tri_tests, st.steps)
        steps = st.steps
        return (hits.dist, hits.bx, hits.by, hits.tri, hits.inst, steps)

    def resh(a):
        return a.reshape(c, chunk)

    thr, bounce, pix, samp = payload
    outs = jax.lax.map(
        chunk_body,
        (resh(ox), resh(oy), resh(oz), resh(dx), resh(dy), resh(dz),
         resh(alive), resh(thr), resh(bounce), resh(pix), resh(samp),
         resh(clamp)))
    dist, bx, by, tri, inst, steps = outs
    return (dist.reshape(r), bx.reshape(r), by.reshape(r),
            tri.reshape(r), inst.reshape(r), steps.sum())


def _wave_pipeline(wa, sa, ctx, table, light, lanes, pix, samp,
                   alive, max_depth, shadow, bilinear, packet, chunk,
                   slab, stage_limit=None, collect_stats=False,
                   trace_fn=None, bounce_packet=None, shadow_packet=None,
                   bounce_fronts=1, bounce_sort_seg=0):
    """The bounce pipeline over one lane set (trace + shadow occlusion +
    shade + spawn, max_depth waves).  Works at any lane count: the
    slab-major frame maps it over slab-sized groups (every intermediate
    — hit records, shade rows, radiance — then lives at slab size
    instead of pool size; ARCHITECTURE.md rule 14), and the
    chunked/anyhit path runs it once over the whole pool.

    Observability hooks (the whole-frame RTU PerfStats analog,
    rt_unit.h:15-45):
    * ``collect_stats=True`` carries PacketStats through every trace and
      returns them per wave (keys 'trace<k>' / 'shadow<k>') so one
      program yields the full-frame divergence/occupancy profile;
    * ``stage_limit=s`` truncates the pipeline after stage s (stage ids:
      1+3k = bounce-k trace, 2+3k = bounce-k shadow, 3+3k = bounce-k
      shade+spawn; 0 = camera only, handled by the caller) and keeps the
      partial results live via the returned ``probe`` scalar — timing
      consecutive limits attributes wall-clock ms to each wave.
    Returns (rad_r, rad_g, rad_b, rays, steps, probe, wave_stats)."""
    ox, oy, oz, dx, dy, dz = lanes
    r = ox.shape[0]
    rad_r = jnp.zeros(r, jnp.float32)
    rad_g = jnp.zeros(r, jnp.float32)
    rad_b = jnp.zeros(r, jnp.float32)
    thr_r = jnp.ones(r, jnp.float32)
    thr_g = jnp.ones(r, jnp.float32)
    thr_b = jnp.ones(r, jnp.float32)
    bounce_ct = jnp.zeros(r, jnp.int32)
    rays_traced = jnp.int32(0)
    steps_total = jnp.int32(0)
    probe = ox.sum() + dx.sum()  # keeps camera gen live under stage 0
    wave_stats = {}
    # per-wave packet size: bounce waves are incoherent (cosine-
    # hemisphere directions), and a packet walks the UNION of its rays'
    # paths, so bounce waves dominate deep path-traced frames (rule
    # 18).  Smaller packets (or the per-ray engine, 0) tighten
    # the union at the cost of more packet-state lanes.
    bounce_packet = packet if bounce_packet is None else bounce_packet
    # shadow_packet None: each shadow wave follows its bounce's packet
    # size (primary-size at bounce 0, bounce_packet after) - measured
    # best; a uniform override is available for experiments
    # bounce_fronts > 1: incoherent (k>0) waves walk F stack nodes per
    # packet per iteration (trace_packets fronts; flat builds only) —
    # coherent bounce-0 waves stay single-front (their walks are short
    # and union-tight; fronts would only inflate visits)
    bounce_fronts = max(int(bounce_fronts or 1), 1)

    def _run(stage):
        return stage_limit is None or stage <= stage_limit

    ah_pred = _inline_anyhit(table, wa)
    # VORTEX_RT_LIVE_SORT: permute bounce-wave lanes live-first (stable
    # argsort on the activity mask) before packetization, and scatter
    # the hit fields back after.  Bounce waves are sparse (only spawned
    # lanes live) — live-first packing turns diluted packets into a
    # dense live prefix plus all-dead packets that exit at entry, so
    # straggler compaction's first rounds shed the dead width instantly.
    # Stable sort preserves tile-major order among live lanes (rule 23:
    # octant re-sorting destroys origin locality; this does not).
    # Bit-identical: packet composition changes which UNION nodes a
    # packet walks, but each ray's closest hit is a min-fold over its
    # own intersecting candidates with a lexicographic (inst,tri)
    # tie-break, and best_t pruning always still visits the leaf of the
    # true closest hit — composition-independent results (same argument
    # as rule 25's whole-packet moves; verified by tests/test_livesort).
    live_sort = _LIVE_SORT_DEFAULT and trace_fn is None
    # bounce_sort_seg > 0: SEGMENTED direction-octant regrouping of
    # incoherent (k>0) waves — stable-sort lanes by
    # (lane//seg) << 4 | octant (dead lanes keyed 15, i.e. last in
    # their segment) before packetization, inverse-scatter hits after.
    # Packets become direction-pure while origins stay within a seg-lane
    # tile window: the middle ground rule 23's GLOBAL octant sort (which
    # destroyed origin locality) never tried; dead-lane grouping also
    # buys live-first packing at segment granularity.  Bit-identical by
    # the packet-composition argument above.
    sort_seg = (int(bounce_sort_seg) if trace_fn is None else 0)

    def _seg_key(tdx, tdy, tdz, act, r_):
        lane = jnp.arange(r_, dtype=jnp.int32)
        oct_ = ((tdx >= 0).astype(jnp.int32)
                | ((tdy >= 0).astype(jnp.int32) << 1)
                | ((tdz >= 0).astype(jnp.int32) << 2))
        return ((lane // sort_seg) << 4) | jnp.where(act, oct_, 15)

    def _perm_trace(fn, act, args6, t_clamp, perm=None, **kw):
        if perm is None:
            perm = jnp.argsort(~act)
        res = fn(*[a[perm] for a in args6], act[perm],
                 None if t_clamp is None else t_clamp[perm], **kw)
        d_, bx_, by_, tr_, in_, st_, ts_ = res

        def inv(a):
            return jnp.zeros_like(a).at[perm].set(a)

        return inv(d_), inv(bx_), inv(by_), inv(tr_), inv(in_), st_, ts_

    pending = None  # hits pre-traced by the previous merged wave
    for bounce in range(max_depth):
        if not _run(1 + bounce * 3):
            break
        wave_packet = packet if bounce == 0 else bounce_packet

        def _trace(tox, toy, toz, tdx, tdy, tdz, act, t_clamp=None,
                   occl=False, stats=False, pk=None):
            if sort_seg > 0 and bounce > 0 and not stats \
                    and r % sort_seg == 0:
                key = _seg_key(tdx, tdy, tdz, act, r)
                return _perm_trace(
                    _trace_raw, act, (tox, toy, toz, tdx, tdy, tdz),
                    t_clamp, perm=jnp.argsort(key, stable=True),
                    occl=occl, pk=pk)
            if live_sort and bounce > 0 and not stats:
                return _perm_trace(
                    _trace_raw, act, (tox, toy, toz, tdx, tdy, tdz),
                    t_clamp, occl=occl, pk=pk)
            return _trace_raw(tox, toy, toz, tdx, tdy, tdz, act,
                              t_clamp, occl, stats, pk)

        def _trace_raw(tox, toy, toz, tdx, tdy, tdz, act, t_clamp=None,
                       occl=False, stats=False, pk=None):
            """Trace a pool-shaped ray set with the configured engine.

            ``trace_fn`` (when given) replaces the local engines entirely
            — the scene-sharded multi-chip path injects its
            local-trace + cross-shard-combine step here
            (parallel.shards).

            ``t_clamp`` bounds the search interval; ``occl=True`` runs the
            packet engine's any-hit occlusion mode (first hit retires the
            ray — the bounded shadow query, rt_unit.cpp:190-213).

            The pool is traced in ``slab``-ray groups (lax.map): each
            group's loop state stays small, and groups exit their loops
            early on sparse waves (bounce/shadow tails), at the price of
            more summed loop iterations (ARCHITECTURE.md rule 14)."""
            if trace_fn is not None:
                return trace_fn(tox, toy, toz, tdx, tdy, tdz, act,
                                t_clamp, occl) + (None,)
            pk = wave_packet if pk is None else pk
            if (pk > 0 and r % pk == 0
                    and (table.anyhit is None or ah_pred is not None)):
                o3 = jnp.stack([tox, toy, toz], axis=1)
                d3 = jnp.stack([tdx, tdy, tdz], axis=1)
                tc = (jnp.full(r, LARGE_FLOAT) if t_clamp is None
                      else t_clamp)
                # incoherent (k>0) waves get the multi-front walk
                fr = bounce_fronts if bounce > 0 else 1
                if 0 < slab < r and r % slab == 0 and not stats:
                    g = r // slab

                    def gbody(args):
                        go, gd, ga, gt = args
                        h, st = trace_packets(
                            wa, go, gd, packet=pk, active=ga,
                            t_max=gt, occlusion=occl,
                            anyhit_pred=ah_pred, fronts=fr)
                        return (h.dist, h.bx, h.by, h.tri, h.inst, st)

                    outs = jax.lax.map(
                        gbody, (o3.reshape(g, slab, 3),
                                d3.reshape(g, slab, 3),
                                act.reshape(g, slab),
                                tc.reshape(g, slab)))
                    return (outs[0].reshape(r), outs[1].reshape(r),
                            outs[2].reshape(r), outs[3].reshape(r),
                            outs[4].reshape(r), outs[5].sum(), None)
                h, st = trace_packets(wa, o3, d3, packet=pk,
                                      active=act, t_max=tc, occlusion=occl,
                                      stats=stats,
                                      anyhit_pred=ah_pred, fronts=fr)
                if stats:
                    return (h.dist, h.bx, h.by, h.tri, h.inst, st.steps,
                            st)
                return h.dist, h.bx, h.by, h.tri, h.inst, st, None
            return _trace_pool(
                wa, sa, ctx, table, (tox, toy, toz, tdx, tdy, tdz), act,
                ((thr_r + thr_g + thr_b) * (1.0 / 3.0), bounce_ct, pix,
                 samp), chunk, t_clamp=t_clamp) + (None,)

        rays_traced = rays_traced + alive.sum(dtype=jnp.int32)
        if pending is None:
            dist, bx, by, tri, inst, steps, tstats = _trace(
                ox, oy, oz, dx, dy, dz, alive, stats=collect_stats)
            steps_total = steps_total + steps
            if tstats is not None:
                wave_stats[f"trace{bounce}"] = tstats
        else:
            # this wave was traced inside the previous bounce's MERGED
            # shadow+bounce call (see below); steps already counted
            dist, bx, by, tri, inst = pending
            pending = None
        if stage_limit is not None:
            probe = probe + dist.sum() + bx.sum() + by.sum()
        if not _run(2 + bounce * 3) and shadow:
            break

        hit = alive & (dist < LARGE_FLOAT)
        miss = alive & ~hit
        tri_c = jnp.clip(tri, 0, sa.shade_rows.shape[0] - 1)
        inst_c = jnp.clip(inst, 0, sa.inst_shade.shape[0] - 1)
        # ---- merged shadow + next-bounce wave ----
        # The shadow wave only needs THIS bounce's hit points, and the
        # continuation rays only need the shader's spawn output — which
        # is lit-independent (ShaderTable.lit_independent_spawn).  So
        # the occlusion query and the next bounce's closest-hit trace
        # run in ONE packet loop (trace_packets occl_split), overlapping
        # their straggler tails, and the shader is evaluated at lit=0
        # and lit=1 with the occlusion result selecting per lane —
        # bitwise-identical to the sequential pipeline.
        sh_pk = shadow_packet
        if sh_pk is None:
            sh_pk = wave_packet
        merge = (shadow and bounce + 1 < max_depth
                 and stage_limit is None and not collect_stats
                 and trace_fn is None
                 and (table.anyhit is None or ah_pred is not None)
                 and getattr(table, "lit_independent_spawn", True)
                 and bounce_packet > 0 and sh_pk == bounce_packet
                 and r % bounce_packet == 0
                 and not (0 < slab < r))
        if shadow:
            # shadow rays need the hit point only — full shading happens
            # after the occlusion result (stage split: shadow ms and
            # shade ms are separately attributable)
            t_hit = jnp.minimum(dist, 1e18)
            hpx, hpy, hpz = (ox + dx * t_hit, oy + dy * t_hit,
                             oz + dz * t_hit)
            # shadow rays: occlusion-test the direct light term
            # (BASELINE config 2 "primary + shadow rays")
            slx = light.light_pos[0] - hpx
            sly = light.light_pos[1] - hpy
            slz = light.light_pos[2] - hpz
            dist_l = jnp.sqrt(slx * slx + sly * sly + slz * slz + 1e-20)
            sdx, sdy, sdz = slx / dist_l, sly / dist_l, slz / dist_l
            sh_act = hit
            rays_traced = rays_traced + sh_act.sum(dtype=jnp.int32)
            if not merge:
                sh_dist, _, _, _, _, sh_steps, shstats = _trace(
                    hpx + sdx * 1e-3, hpy + sdy * 1e-3, hpz + sdz * 1e-3,
                    sdx, sdy, sdz, sh_act,
                    t_clamp=dist_l * (1.0 - 1e-3), occl=True,
                    stats=collect_stats, pk=sh_pk)
                steps_total = steps_total + sh_steps
                if shstats is not None:
                    wave_stats[f"shadow{bounce}"] = shstats
                if stage_limit is not None:
                    probe = probe + sh_dist.sum()
                occluded = sh_act & (sh_dist < dist_l * (1.0 - 1e-3))
        if not _run(3 + bounce * 3):
            break
        sp = shade_point(sa, ox, oy, oz, dx, dy, dz,
                         dist, bx, by, 1.0 - bx - by, tri_c, inst_c,
                         bilinear=bilinear)
        ray = RayLanes(ox, oy, oz, dx, dy, dz)
        pl = PayloadLanes((thr_r + thr_g + thr_b) * (1.0 / 3.0),
                          bounce_ct, pix, samp)

        if shadow and merge:
            ones = jnp.ones(r, jnp.float32)
            co1 = table.closest(ctx, sp._replace(lit=ones), ray, pl)
            co0 = table.closest(ctx, sp._replace(lit=ones * 0.0), ray, pl)
            spawn = hit & co1.spawn
            n_ox = jnp.where(spawn, co1.sox, ox)
            n_oy = jnp.where(spawn, co1.soy, oy)
            n_oz = jnp.where(spawn, co1.soz, oz)
            n_dx = jnp.where(spawn, co1.sdx, dx)
            n_dy = jnp.where(spawn, co1.sdy, dy)
            n_dz = jnp.where(spawn, co1.sdz, dz)
            # (spawned-ray counting happens at the next iteration's top,
            # exactly as in the sequential pipeline)
            if (sort_seg > 0 and r % sort_seg == 0) or live_sort:
                # permuted packing per half (the occl_split boundary
                # stays packet-aligned at r); unpermuted below.  In
                # sort_seg mode the bounce half gets the segmented
                # octant key (shadow directions point at one light and
                # are already coherent — only dead-lane grouping, which
                # the segment key also provides via the act term);
                # live_sort mode keeps the round-4 liveness packing.
                if sort_seg > 0 and r % sort_seg == 0:
                    perm_s = jnp.argsort(
                        _seg_key(sdx, sdy, sdz, sh_act, r), stable=True)
                    perm_b = jnp.argsort(
                        _seg_key(n_dx, n_dy, n_dz, spawn, r), stable=True)
                else:
                    perm_s = jnp.argsort(~sh_act)
                    perm_b = jnp.argsort(~spawn)

                def halves(s_half, b_half):
                    return jnp.concatenate([s_half[perm_s],
                                            b_half[perm_b]])

                def unp_s(a):
                    return jnp.zeros_like(a).at[perm_s].set(a)

                def unp_b(a):
                    return jnp.zeros_like(a).at[perm_b].set(a)
            else:
                def halves(s_half, b_half):
                    return jnp.concatenate([s_half, b_half])

                def unp_s(a):
                    return a

                unp_b = unp_s

            m_o = jnp.stack([halves(hpx + sdx * 1e-3, n_ox),
                             halves(hpy + sdy * 1e-3, n_oy),
                             halves(hpz + sdz * 1e-3, n_oz)], axis=1)
            m_d = jnp.stack([halves(sdx, n_dx), halves(sdy, n_dy),
                             halves(sdz, n_dz)], axis=1)
            m_act = halves(sh_act, spawn)
            m_tc = halves(dist_l * (1.0 - 1e-3),
                          jnp.full(r, LARGE_FLOAT))
            # the merged wave always carries trace_{bounce+1} (incoherent
            # for every bounce) — it gets the multi-front walk
            hm, m_steps = trace_packets(
                wa, m_o, m_d, packet=bounce_packet, active=m_act,
                t_max=m_tc, occl_split=r, anyhit_pred=ah_pred,
                fronts=bounce_fronts)
            steps_total = steps_total + m_steps
            sh_dist = unp_s(hm.dist[:r])
            occluded = sh_act & (sh_dist < dist_l * (1.0 - 1e-3))
            pending = (unp_b(hm.dist[r:]), unp_b(hm.bx[r:]),
                       unp_b(hm.by[r:]), unp_b(hm.tri[r:]),
                       unp_b(hm.inst[r:]))
            # per-lane lit selection == computing with the gated lit
            occ = occluded

            def blend(a, b_):
                return jnp.where(occ, a, b_)

            co = co1._replace(
                add_r=blend(co0.add_r, co1.add_r),
                add_g=blend(co0.add_g, co1.add_g),
                add_b=blend(co0.add_b, co1.add_b),
                mul_r=blend(co0.mul_r, co1.mul_r),
                mul_g=blend(co0.mul_g, co1.mul_g),
                mul_b=blend(co0.mul_b, co1.mul_b))
        else:
            if shadow:
                sp = sp._replace(lit=jnp.where(occluded, 0.0, 1.0))
            co = table.closest(ctx, sp, ray, pl)
            spawn = hit & co.spawn
        mr, mg, mb = table.miss(ctx, ray, pl)

        rad_r = rad_r + jnp.where(hit, thr_r * co.add_r,
                                  jnp.where(miss, thr_r * mr, 0.0))
        rad_g = rad_g + jnp.where(hit, thr_g * co.add_g,
                                  jnp.where(miss, thr_g * mg, 0.0))
        rad_b = rad_b + jnp.where(hit, thr_b * co.add_b,
                                  jnp.where(miss, thr_b * mb, 0.0))
        thr_r = jnp.where(hit, thr_r * co.mul_r, thr_r)
        thr_g = jnp.where(hit, thr_g * co.mul_g, thr_g)
        thr_b = jnp.where(hit, thr_b * co.mul_b, thr_b)

        ox = jnp.where(spawn, co.sox, ox)
        oy = jnp.where(spawn, co.soy, oy)
        oz = jnp.where(spawn, co.soz, oz)
        dx = jnp.where(spawn, co.sdx, dx)
        dy = jnp.where(spawn, co.sdy, dy)
        dz = jnp.where(spawn, co.sdz, dz)
        alive = spawn
        bounce_ct = jnp.where(spawn, bounce_ct + 1, bounce_ct)

    return (rad_r, rad_g, rad_b, rays_traced, steps_total, probe,
            wave_stats)


def frame_body(wa: WideArrays, sa: ShadeArrays, cam: CameraArrays,
               light: LightArrays, width: int, height: int,
               n_pix: int, pix_offset: int,
               max_depth: int = 2, spp: int = 1, chunk: int = 4096,
               table: ShaderTable = None, seed: int = 0,
               packet: int = 128, pix_perm=None, shadow: bool = False,
               tile_w: int = 16, tile_h: int = 16,
               total_spp: Optional[int] = None,
               bilinear: bool = False, slab: int = 32768,
               stage_limit: Optional[int] = None,
               collect_stats: bool = False, trace_fn=None,
               bounce_packet: Optional[int] = None,
               shadow_packet: Optional[int] = None,
               bounce_fronts: int = 1, bounce_sort_seg: int = 0):
    """Traceable wavefront frame over ``n_pix`` pixels (``pix_offset``
    must be a whole number of rows for the tiled layout).  Returns
    ((n_pix, 3) radiance in row-major pixel order, rays, steps).  Used by
    render_wavefront (whole frame) and parallel.tiles (row block per
    device).

    Design (docs/ARCHITECTURE.md): each slab's wave is one trace_packets
    call, and the frame has no pool-scale argsorts or gathers — pixel
    ids are integer arithmetic on the lane index, rays never move
    between lanes (no per-bounce compaction), and the spp/tile resolve
    is a pure reshape+transpose.

    ``packet`` > 0 traces with the packet engine (ops.traverse_packet)
    when no any-hit shader is bound; 0 forces the per-ray engine (which
    still chunks by ``chunk`` over a lax.map — the any-hit suspension
    protocol needs per-ray state)."""
    if table is None:
        table = ShaderTable()
    seed_u = jnp.asarray(seed).astype(jnp.uint32)
    ctx = ShaderContext(
        shade=sa, light_pos=light.light_pos, light_color=light.light_color,
        ambient=light.ambient, background=light.background,
        max_depth=max_depth, seed=seed_u)
    # total_spp: the stratification denominator — accumulation passes
    # (render_accum) spread `spp` lanes per pass over spp*n_passes strata
    total_spp = spp if total_spp is None else total_spp

    rows = n_pix // width
    # pix_offset may be traced (multi-chip: dev * n_pix_local); row
    # alignment is then an API precondition (n_pix_local is a whole
    # number of rows, so every device offset is too)
    off_aligned = (pix_offset % width == 0
                   if isinstance(pix_offset, int) else True)
    # adaptive tile height: 1080 rows don't divide by the default 16 —
    # fall back through 8/4/2 so odd frame heights still get tile-major
    # packet coherence + the gather-free resolve
    if width % tile_w == 0 and n_pix % width == 0:
        for th in (tile_h, 8, 4, 2):
            if rows % th == 0:
                tile_h = th
                break
    tiled = (width % tile_w == 0 and n_pix % width == 0
             and rows % tile_h == 0 and off_aligned)
    inline_ah = table.anyhit is None or _inline_anyhit(table, wa) is not None
    slab_major = (packet > 0 and inline_ah and pix_perm is None
                  and 0 < slab < n_pix)

    if slab_major:
        # ---- streamed slab-major frame (the scale path) ----
        # The pool is ONE SAMPLE per pixel, padded to whole slabs; spp
        # streams as lax.scan passes that accumulate into the (r,)
        # radiance planes.  Each slab generates its own camera rays from
        # the slab index (pure lane arithmetic, zero pool-scale
        # intermediates), so resident memory is O(n_pix) for the
        # accumulator + O(slab) for loop state — 1080p x spp8 never
        # materializes a 16.6M-lane pool.
        r = ((n_pix + slab - 1) // slab) * slab
        g = r // slab
        row0 = pix_offset // width if off_aligned else 0

        def sbody(args_in):
            gi, samp_scalar = args_in
            lane = gi * slab + jnp.arange(slab, dtype=jnp.int32)
            alive = lane < n_pix
            q = jnp.minimum(lane, n_pix - 1)
            if tiled:
                pxi, pyi = _tile_pixel_ids(q, width, tile_w, tile_h, row0)
                pix = pyi * width + pxi
            else:
                p = pix_offset + q
                pxi, pyi = p % width, p // width
                pix = p
            samp = jnp.full((slab,), samp_scalar, jnp.uint32)
            lanes6 = _camera_from_pix(cam, width, height, pxi, pyi, pix,
                                      samp, total_spp)
            rr, rg, rb, rays, steps, probe, wstats = _wave_pipeline(
                wa, sa, ctx, table, light, lanes6, pix, samp, alive,
                max_depth, shadow, bilinear, packet, chunk, 0,
                stage_limit=stage_limit, collect_stats=collect_stats,
                trace_fn=trace_fn, bounce_packet=bounce_packet,
                shadow_packet=shadow_packet,
                bounce_fronts=bounce_fronts, bounce_sort_seg=bounce_sort_seg)
            return rr, rg, rb, rays, steps, probe, wstats

        gis = jnp.arange(g, dtype=jnp.int32)

        def one_pass(samp_scalar):
            outs = jax.lax.map(
                sbody, (gis, jnp.full((g,), samp_scalar, jnp.uint32)))
            return (outs[0].reshape(r), outs[1].reshape(r),
                    outs[2].reshape(r), outs[3].sum(), outs[4].sum(),
                    outs[5].sum(), jax.tree.map(lambda a: a.sum(), outs[6]))

        if spp == 1:
            (rad_r, rad_g, rad_b, rays_traced, steps_total, probe,
             wstats) = one_pass(seed_u * jnp.uint32(spp))
        else:
            def pass_body(acc, samp_scalar):
                rr, rg, rb, rays, steps, probe, ws = one_pass(samp_scalar)
                return (acc[0] + rr, acc[1] + rg, acc[2] + rb,
                        acc[3] + rays, acc[4] + steps, acc[5] + probe,
                        jax.tree.map(jnp.add, acc[6], ws)), None

            samps = (seed_u * jnp.uint32(spp)
                     + jnp.arange(spp, dtype=jnp.uint32))
            zstats = ({} if not collect_stats else jax.tree.map(
                lambda sd: jnp.zeros(sd.shape, sd.dtype),
                jax.eval_shape(lambda s: one_pass(s)[6],
                               jnp.uint32(0))))
            acc0 = (jnp.zeros(r, jnp.float32), jnp.zeros(r, jnp.float32),
                    jnp.zeros(r, jnp.float32), jnp.int32(0), jnp.int32(0),
                    jnp.float32(0), zstats)
            (rad_r, rad_g, rad_b, rays_traced, steps_total, probe,
             wstats), _ = jax.lax.scan(pass_body, acc0, samps)

        inv_spp = jnp.float32(1.0 / spp)
        if tiled:
            img = jnp.stack([
                _resolve_tiled(c[:n_pix] * inv_spp, width, rows, 1,
                               tile_w, tile_h).reshape(n_pix)
                for c in (rad_r, rad_g, rad_b)])
        else:
            img = jnp.stack([rad_r[:n_pix], rad_g[:n_pix],
                             rad_b[:n_pix]]) * inv_spp
        if stage_limit is not None:
            # staged profiling: keep every executed wave live through the
            # image checksum (render_burst reduces to one scalar)
            img = img + probe * jnp.float32(1e-6)
        if collect_stats:
            return img, rays_traced, steps_total, wstats
        return img, rays_traced, steps_total

    # ---- legacy monolithic pool (any-hit suspension / per-ray engine /
    # explicit pixel permutations): spp folded into the pool ----
    n_real = n_pix * spp
    quantum = packet if (packet > 0 and inline_ah) else chunk
    r = ((n_real + quantum - 1) // quantum) * quantum
    # global sample index per lane: pass `seed` contributes spp samples
    samp = (seed_u * jnp.uint32(spp)
            + (jnp.arange(n_real, dtype=jnp.int32) % spp).astype(jnp.uint32))
    if tiled:
        ox, oy, oz, dx, dy, dz, pix = _camera_lanes_tiled(
            cam, width, height, spp, samp, total_spp, tile_w, tile_h,
            n_pix, pix_offset // width)
    else:
        ox, oy, oz, dx, dy, dz, pix = _camera_lanes(
            cam, width, height, spp, samp, total_spp, n_pix=n_pix,
            pix_offset=pix_offset, pix_perm=pix_perm)

    def pad(a, fill=0):
        return jnp.concatenate(
            [a, jnp.full(r - n_real, fill, a.dtype)]) if r > n_real else a

    ox, oy, oz = pad(ox), pad(oy), pad(oz)
    dx, dy, dz = pad(dx), pad(dy, 1.0), pad(dz)
    pix = pad(pix, -1)  # padding lanes get an out-of-range pixel id
    samp = pad(samp)
    alive = jnp.arange(r, dtype=jnp.int32) < n_real
    args = (ox, oy, oz, dx, dy, dz)
    (rad_r, rad_g, rad_b, rays_traced, steps_total, probe,
     wstats) = _wave_pipeline(
        wa, sa, ctx, table, light, args, pix, samp, alive,
        max_depth, shadow, bilinear, packet, chunk, slab,
        stage_limit=stage_limit, collect_stats=collect_stats,
        trace_fn=trace_fn, bounce_packet=bounce_packet,
        shadow_packet=shadow_packet,
        bounce_fronts=bounce_fronts, bounce_sort_seg=bounce_sort_seg)

    # ---- resolve: rays never moved lanes, so pool order IS (pixel, spp)
    # order; tile-major lanes resolve with a reshape+transpose.  Channels
    # stay as (3, n_pix) PLANES, so the minor axis is the long pixel axis
    # rather than a 3-wide one (ARCHITECTURE.md rule 3).  Callers stack
    # to (H, W, 3) once, at the edge. ----
    if tiled:
        img = jnp.stack([
            _resolve_tiled(c[:n_real], width, rows, spp, tile_w, tile_h)
            .reshape(n_pix) for c in (rad_r, rad_g, rad_b)])
    else:
        img = jnp.stack([
            rad_r[:n_real].reshape(n_pix, spp).mean(1),
            rad_g[:n_real].reshape(n_pix, spp).mean(1),
            rad_b[:n_real].reshape(n_pix, spp).mean(1)])
    if stage_limit is not None:
        img = img + probe * jnp.float32(1e-6)
    if collect_stats:
        return img, rays_traced, steps_total, wstats
    return img, rays_traced, steps_total


@partial(jax.jit,
         static_argnames=("width", "height", "max_depth", "spp", "chunk",
                          "table", "packet", "shadow", "tile_w", "tile_h",
                          "bilinear", "bounce_packet", "shadow_packet",
                          "bounce_fronts", "slab", "bounce_sort_seg"))
def render_wavefront(wa: WideArrays, sa: ShadeArrays, cam: CameraArrays,
                     light: LightArrays, width: int, height: int,
                     max_depth: int = 2, spp: int = 1, chunk: int = 4096,
                     table: ShaderTable = None, seed: int = 0,
                     packet: int = 128, shadow: bool = False,
                     tile_w: int = 16, tile_h: int = 16,
                     bilinear: bool = False, bounce_packet=None,
                     shadow_packet=None,
                     bounce_fronts: int = 1, slab: int = 32768,
                     bounce_sort_seg: int = 0):
    """Full frame -> ((H, W, 3) radiance, rays traced, traversal steps)."""
    img, rays, steps = frame_body(
        wa, sa, cam, light, width, height, width * height, 0,
        max_depth=max_depth, spp=spp, chunk=chunk, table=table, seed=seed,
        packet=packet, shadow=shadow, tile_w=tile_w, tile_h=tile_h,
        bilinear=bilinear, bounce_packet=bounce_packet,
        shadow_packet=shadow_packet,
        bounce_fronts=bounce_fronts, slab=slab,
        bounce_sort_seg=bounce_sort_seg)
    return (img.reshape(3, height, width).transpose(1, 2, 0),
            rays, steps)


def render_frame(wa, sa, cam, light, width, height, max_depth=2, spp=1,
                 chunk=4096, table=None, seed=0, packet=128,
                 tile_w=16, tile_h=16, shadow=False, bilinear=False,
                 bounce_packet=None, shadow_packet=None,
                 bounce_fronts=1, slab=32768, bounce_sort_seg=0):
    """Host wrapper around render_wavefront (kept as the stable API)."""
    return render_wavefront(
        wa, sa, cam, light, width, height, max_depth=max_depth, spp=spp,
        chunk=chunk, table=table, seed=seed, packet=packet,
        shadow=shadow, tile_w=tile_w, tile_h=tile_h, bilinear=bilinear,
        bounce_packet=bounce_packet, shadow_packet=shadow_packet,
        bounce_fronts=bounce_fronts, slab=slab,
        bounce_sort_seg=bounce_sort_seg)


@partial(jax.jit,
         static_argnames=("width", "height", "max_depth", "spp", "chunk",
                          "table", "packet", "shadow", "tile_w", "tile_h",
                          "n_frames", "bounce_packet", "shadow_packet",
                          "bounce_fronts", "slab", "bounce_sort_seg"))
def render_burst(wa: WideArrays, sa: ShadeArrays, cam: CameraArrays,
                 light: LightArrays, width: int, height: int,
                 n_frames: int = 16, seed0=0,
                 max_depth: int = 2, spp: int = 1, chunk: int = 4096,
                 table: ShaderTable = None,
                 packet: int = 128, shadow: bool = False,
                 tile_w: int = 16, tile_h: int = 16,
                 bounce_packet=None, shadow_packet=None,
                 bounce_fronts: int = 1, slab: int = 32768,
                 bounce_sort_seg: int = 0):
    """Render ``n_frames`` frames (seeds seed0..seed0+n-1) inside ONE XLA
    program, reduced to ONE i32: the exact total ray count (plus an
    always-zero anti-DCE guard derived from the radiance checksum).  No
    image output — callers that want a frame render it with
    render_wavefront as a separate program (see
    WavefrontRenderer.render_burst).

    This is the sustained-throughput entry point: one dispatch per
    burst, so host dispatch latency is paid once per burst rather than
    once per frame.  It is also the natural animation API (per-frame
    seeds advance the sampler).

    The radiance checksum keeps shading and shadow traces live (the ray
    counter alone would let XLA dead-code the lighting) and folds into
    the ray count as an always-zero i32 guard (docs/ARCHITECTURE.md
    rules 12-13)."""

    def body(seed):
        img, rays, steps = frame_body(
            wa, sa, cam, light, width, height, width * height, 0,
            max_depth=max_depth, spp=spp, chunk=chunk, table=table,
            seed=seed, packet=packet, shadow=shadow,
            tile_w=tile_w, tile_h=tile_h,
            bounce_packet=bounce_packet, shadow_packet=shadow_packet,
            bounce_fronts=bounce_fronts,
            slab=slab, bounce_sort_seg=bounce_sort_seg)
        return img.sum(), rays, steps

    seeds = jnp.asarray(seed0) + jnp.arange(n_frames, dtype=jnp.int32)
    c, r, s = jax.lax.map(body, seeds)
    guard = (c.sum() * jnp.float32(1e-30)).astype(jnp.int32)  # always 0
    return r.sum() + guard


@partial(jax.jit,
         static_argnames=("width", "height", "max_depth", "spp", "chunk",
                          "table", "packet", "shadow", "tile_w", "tile_h",
                          "n_passes", "bounce_packet", "shadow_packet",
                          "bounce_fronts", "slab", "bounce_sort_seg"))
def render_accum(wa: WideArrays, sa: ShadeArrays, cam: CameraArrays,
                 light: LightArrays, width: int, height: int,
                 n_passes: int = 4, seed0=0,
                 max_depth: int = 2, spp: int = 1, chunk: int = 4096,
                 table: ShaderTable = None,
                 packet: int = 128, shadow: bool = False,
                 tile_w: int = 16, tile_h: int = 16, bounce_packet=None,
                 shadow_packet=None, bounce_fronts: int = 1,
                 slab: int = 32768, bounce_sort_seg: int = 0):
    """Progressive accumulation: average ``n_passes`` frames (stratified
    over spp*n_passes total samples per pixel) inside ONE XLA program.
    Returns ((H, W, 3) image, total rays, total steps).

    This is how high-spp configs run at scale: BASELINE config 4 wants
    8 spp over a 1080p 260k-tri scene; folding all samples into one pool
    (R = w*h*8 = 16.6M lanes) would multiply traversal state past HBM
    comfort, while each pass at spp lanes keeps pool memory flat and the
    in-program lax.scan keeps dispatch count at one (ARCHITECTURE.md
    rule 11).  Per iteration the scan carries only the (3, n_pix)
    accumulator (one add per pass — unlike per-frame outputs, a carry
    does not allocate per-iteration buffers)."""
    total = spp * n_passes

    def body(acc, seed):
        img, rays, steps = frame_body(
            wa, sa, cam, light, width, height, width * height, 0,
            max_depth=max_depth, spp=spp, chunk=chunk, table=table,
            seed=seed, packet=packet, shadow=shadow,
            tile_w=tile_w, tile_h=tile_h, total_spp=total,
            bounce_packet=bounce_packet, shadow_packet=shadow_packet,
            bounce_fronts=bounce_fronts, slab=slab,
            bounce_sort_seg=bounce_sort_seg)
        a_img, a_rays, a_steps = acc
        return (a_img + img, a_rays + rays, a_steps + steps), None

    seeds = jnp.asarray(seed0) + jnp.arange(n_passes, dtype=jnp.int32)
    acc0 = (jnp.zeros((3, width * height), jnp.float32), jnp.int32(0),
            jnp.int32(0))
    (img, rays, steps), _ = jax.lax.scan(body, acc0, seeds)
    out = (img * (1.0 / n_passes)).reshape(3, height, width)
    return out.transpose(1, 2, 0), rays, steps


@partial(jax.jit,
         static_argnames=("width", "height", "max_depth", "spp", "chunk",
                          "table", "packet", "shadow", "tile_w", "tile_h",
                          "n_frames", "stage_limit",
                          "bounce_packet", "shadow_packet",
                          "bounce_fronts", "slab", "bounce_sort_seg"))
def render_profile_burst(wa: WideArrays, sa: ShadeArrays, cam: CameraArrays,
                         light: LightArrays, width: int, height: int,
                         n_frames: int = 8, seed0=0,
                         max_depth: int = 2, spp: int = 1, chunk: int = 4096,
                         table: ShaderTable = None,
                         packet: int = 128, shadow: bool = False,
                         tile_w: int = 16, tile_h: int = 16,
                         stage_limit: int = 0,
                         bounce_packet=None, shadow_packet=None,
                         bounce_fronts: int = 1, slab: int = 32768,
                         bounce_sort_seg: int = 0):
    """Stage-truncated burst for wall-clock attribution: same scalar-only
    shape as render_burst but the frame stops after ``stage_limit`` (0 =
    camera only; 1+3k / 2+3k / 3+3k = bounce-k trace / shadow / shade).
    Timing consecutive limits yields the per-wave ms breakdown that
    round 2 derived by hand (ARCHITECTURE.md frame budget).  Threads the
    same packet/fronts/slab knobs as render_burst so stage attribution
    measures the CONFIGURED frame, not the defaults."""

    def body(seed):
        img, rays, steps = frame_body(
            wa, sa, cam, light, width, height, width * height, 0,
            max_depth=max_depth, spp=spp, chunk=chunk, table=table,
            seed=seed, packet=packet, shadow=shadow,
            tile_w=tile_w, tile_h=tile_h,
            stage_limit=stage_limit, bounce_packet=bounce_packet,
            shadow_packet=shadow_packet, bounce_fronts=bounce_fronts,
            slab=slab, bounce_sort_seg=bounce_sort_seg)
        return img.sum(), rays, steps

    seeds = jnp.asarray(seed0) + jnp.arange(n_frames, dtype=jnp.int32)
    c, r, s = jax.lax.map(body, seeds)
    guard = (c.sum() * jnp.float32(1e-30)).astype(jnp.int32)  # always 0
    return r.sum() + guard


@partial(jax.jit,
         static_argnames=("width", "height", "max_depth", "spp", "chunk",
                          "table", "packet", "shadow", "tile_w", "tile_h",
                          "bounce_packet", "shadow_packet",
                          "bounce_fronts", "slab", "bounce_sort_seg"))
def render_stats(wa: WideArrays, sa: ShadeArrays, cam: CameraArrays,
                 light: LightArrays, width: int, height: int,
                 max_depth: int = 2, spp: int = 1, chunk: int = 4096,
                 table: ShaderTable = None, seed: int = 0,
                 packet: int = 128, shadow: bool = False,
                 tile_w: int = 16, tile_h: int = 16,
                 bounce_packet=None, shadow_packet=None,
                 bounce_fronts: int = 1, slab: int = 32768,
                 bounce_sort_seg: int = 0):
    """One frame with whole-frame PacketStats: returns (rays, steps,
    {wave: PacketStats}) — the full-frame RTU PerfStats analog
    (rt_unit.h:15-45), per wave (primary / shadow / bounce-k)."""
    img, rays, steps, wstats = frame_body(
        wa, sa, cam, light, width, height, width * height, 0,
        max_depth=max_depth, spp=spp, chunk=chunk, table=table, seed=seed,
        packet=packet, shadow=shadow, tile_w=tile_w, tile_h=tile_h,
        bounce_packet=bounce_packet, shadow_packet=shadow_packet,
        bounce_fronts=bounce_fronts, slab=slab,
        bounce_sort_seg=bounce_sort_seg, collect_stats=True)
    return rays + (img.sum() * jnp.float32(1e-30)).astype(jnp.int32), \
        steps, wstats


# ---------------------------------------------------------------------------
# host-orchestrated chunked path (diagnostic mode)
#
# One small jit per chunk trace, dispatched from the host (JAX's async
# dispatch pipelines them), plus one jit each for ray gen, compaction,
# shading, and resolve.  This is close in spirit to the reference, where
# the host driver orchestrates device kernels (tracer.cpp).
# ---------------------------------------------------------------------------

@partial(jax.jit, donate_argnums=())
def _trace_chunk_jit(wa: WideArrays, ox, oy, oz, dx, dy, dz, alive):
    st = init_state_lanes(ox, oy, oz, dx, dy, dz)
    st = st._replace(best_t=jnp.where(alive, LARGE_FLOAT, -1.0), done=~alive)
    hits, st, perf = trace_lanes(wa, ox, oy, oz, dx, dy, dz, state=st)
    return hits.dist, hits.bx, hits.by, hits.tri, hits.inst, st.steps


@partial(jax.jit, static_argnames=("chunk",))
def _split_pool(ox, oy, oz, dx, dy, dz, alive, chunk: int):
    c = ox.shape[0] // chunk
    outs = []
    for i in range(c):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, i * chunk, chunk)
        outs.append((sl(ox), sl(oy), sl(oz), sl(dx), sl(dy), sl(dz),
                     sl(alive)))
    return outs


@partial(jax.jit, static_argnames=("max_depth",))
def _shade_pool_default(sa: ShadeArrays, light: LightArrays, max_depth: int,
                        ox, oy, oz, dx, dy, dz, alive,
                        dist, bx, by, tri, inst,
                        rad_r, rad_g, rad_b, thr, bounce_ct, pix):
    """Default-shader-table shading of the whole pool (one program)."""
    ctx = ShaderContext(
        shade=sa, light_pos=light.light_pos, light_color=light.light_color,
        ambient=light.ambient, background=light.background,
        max_depth=max_depth)
    table = ShaderTable()
    hit = alive & (dist < LARGE_FLOAT)
    miss = alive & ~hit
    tri_c = jnp.clip(tri, 0, sa.shade_rows.shape[0] - 1)
    inst_c = jnp.clip(inst, 0, sa.inst_shade.shape[0] - 1)
    sp = shade_point(sa, ox, oy, oz, dx, dy, dz,
                     dist, bx, by, 1.0 - bx - by, tri_c, inst_c)
    ray = RayLanes(ox, oy, oz, dx, dy, dz)
    pl = PayloadLanes(thr, bounce_ct, pix, pix.astype(jnp.uint32))
    co = table.closest(ctx, sp, ray, pl)
    mr, mg, mb = table.miss(ctx, ray, pl)
    rad_r = rad_r + jnp.where(hit, thr * co.add_r,
                              jnp.where(miss, thr * mr, 0.0))
    rad_g = rad_g + jnp.where(hit, thr * co.add_g,
                              jnp.where(miss, thr * mg, 0.0))
    rad_b = rad_b + jnp.where(hit, thr * co.add_b,
                              jnp.where(miss, thr * mb, 0.0))
    thr = jnp.where(hit, thr * co.mul_r, thr)
    spawn = hit & co.spawn
    ox = jnp.where(spawn, co.sox, ox)
    oy = jnp.where(spawn, co.soy, oy)
    oz = jnp.where(spawn, co.soz, oz)
    dx = jnp.where(spawn, co.sdx, dx)
    dy = jnp.where(spawn, co.sdy, dy)
    dz = jnp.where(spawn, co.sdz, dz)
    bounce_ct = jnp.where(spawn, bounce_ct + 1, bounce_ct)
    return (ox, oy, oz, dx, dy, dz, spawn, rad_r, rad_g, rad_b, thr,
            bounce_ct)


@jax.jit
def _compact_pool(ox, oy, oz, dx, dy, dz, alive, rad_r, rad_g, rad_b,
                  thr, bounce_ct, pix, slot):
    order = jnp.argsort(~alive, stable=True)
    return tuple(a[order] for a in (ox, oy, oz, dx, dy, dz, alive, rad_r,
                                    rad_g, rad_b, thr, bounce_ct, pix, slot))


@partial(jax.jit, static_argnames=("n_pix", "spp", "n_real"))
def _resolve(rad_r, rad_g, rad_b, slot, n_pix: int, spp: int, n_real: int):
    inv = jnp.argsort(slot, stable=True)
    rr, rg, rb = rad_r[inv], rad_g[inv], rad_b[inv]
    return jnp.stack([
        rr[:n_real].reshape(n_pix, spp).mean(1),
        rg[:n_real].reshape(n_pix, spp).mean(1),
        rb[:n_real].reshape(n_pix, spp).mean(1)], axis=-1)


@partial(jax.jit, static_argnames=("width", "height", "spp", "chunk"))
def _gen_pool(cam: CameraArrays, width: int, height: int, spp: int,
              chunk: int, seed: int = 0):
    n_real = width * height * spp
    r = ((n_real + chunk - 1) // chunk) * chunk
    samp = (jnp.asarray(seed).astype(jnp.uint32) * jnp.uint32(spp)
            + (jnp.arange(n_real, dtype=jnp.int32) % spp).astype(jnp.uint32))
    ox, oy, oz, dx, dy, dz, pix = _camera_lanes(cam, width, height, spp,
                                                samp, spp)

    def pad(a, fill=0):
        return jnp.concatenate(
            [a, jnp.full(r - n_real, fill, a.dtype)]) if r > n_real else a

    return (pad(ox), pad(oy), pad(oz), pad(dx), pad(dy, 1.0), pad(dz),
            pad(pix, width * height), jnp.arange(r, dtype=jnp.int32),
            jnp.arange(r, dtype=jnp.int32) < n_real)


@dataclasses.dataclass
class WavefrontRenderer:
    """Host-facing flagship renderer (Tracer analog, tracer.cpp)."""

    sb: SceneBuffers
    wa: WideArrays
    sa: ShadeArrays
    config: RTConfig
    table: ShaderTable
    # device-array cache for the last (camera, params) pair: render
    # loops re-use the same camera/lights every call, so the host->device
    # upload happens once
    _dev_cache: dict = dataclasses.field(default_factory=dict)

    def _dev_args(self, cam: Camera, params: RenderParams):
        key = (repr(cam), repr(params))
        hit = self._dev_cache.get("key") == key
        if not hit:
            self._dev_cache.update(
                key=key,
                cam=CameraArrays.from_camera(cam),
                light=LightArrays.from_params(params))
        return self._dev_cache["cam"], self._dev_cache["light"]

    @staticmethod
    def from_scene(scene: Scene, config: Optional[RTConfig] = None,
                   table: Optional[ShaderTable] = None) -> "WavefrontRenderer":
        cfg = config or RTConfig()
        return WavefrontRenderer.from_buffers(scene.build(cfg), cfg, table)

    @staticmethod
    def from_buffers(sb_host: SceneBuffers, config: Optional[RTConfig] = None,
                     table: Optional[ShaderTable] = None
                     ) -> "WavefrontRenderer":
        cfg = config or RTConfig()
        wa = WideArrays.from_scene(sb_host, width=cfg.bvh_width)
        env_fused = os.environ.get("VORTEX_RT_FUSED_ROWS")
        fused = cfg.fused_rows if env_fused is None else env_fused == "1"
        if fused and wa.num_tlas == 0 and wa.tri_bits > 0:
            # single-gather node+leaf rows (flat builds; sweep winner,
            # ARCHITECTURE.md rule 29; see WideArrays.fuse)
            wa = wa.fuse()
        table = table or ShaderTable()
        if (getattr(table.anyhit, "alpha_threshold", None) is not None
                or getattr(table.anyhit, "inline_predicate", None)
                is not None):
            # declarative stateless any-hit (alpha test or custom
            # predicate): build the in-loop tables so the packet/slab
            # frame path handles it (engine._inline_anyhit)
            wa = wa.with_alpha(sb_host)
        return WavefrontRenderer(
            sb=jax.tree.map(jnp.asarray, sb_host),
            wa=wa,
            sa=ShadeArrays.from_scene(sb_host),
            config=cfg,
            table=table,
        )

    def render(self, cam: Camera, params: RenderParams,
               width: Optional[int] = None, height: Optional[int] = None,
               mode: str = "auto") -> Tuple[np.ndarray, int]:
        """mode: 'fused' = one-jit frame (the default: one dispatch per
        frame); 'chunked' = host-orchestrated per-chunk dispatch, kept for
        diagnosis and as the pattern for external work queues.
        'auto' = fused."""
        w = width or self.config.width
        h = height or self.config.height
        if mode == "auto":
            mode = "fused"
        table = self._table_for(params)
        if mode == "chunked":
            if table != ShaderTable() or params.shadow:
                # the chunked orchestrator shades with the default-table
                # program only (and has no shadow pass); run fused
                import warnings
                warnings.warn(
                    "mode='chunked' supports only the default shader table "
                    "without shadows; falling back to mode='fused'",
                    stacklevel=2)
                mode = "fused"
            else:
                return self._render_chunked(cam, params, w, h)
        ca, light = self._dev_args(cam, params)
        img, nrays, _ = render_frame(
            self.wa, self.sa, ca, light, w, h,
            max_depth=params.max_depth, spp=params.spp,
            chunk=self.config.lanes, table=table,
            packet=self.config.packet_size,
            tile_w=self.config.tile_w, tile_h=self.config.tile_h,
            shadow=params.shadow,
            bilinear=self.config.tex_filter == "bilinear",
            bounce_packet=self.config.bounce_packet,
            shadow_packet=self.config.shadow_packet,
            bounce_fronts=self.config.bounce_fronts,
            bounce_sort_seg=self.config.bounce_sort_seg,
            slab=self.config.slab)
        return np.asarray(img), int(nrays)

    def _table_for(self, params: RenderParams) -> ShaderTable:
        """params.pathtrace swaps the Whitted closest shader for the
        path-traced one (configs 3-4 'spp path trace') unless the user
        installed a custom table."""
        if params.pathtrace and self.table == ShaderTable():
            from vortex_rt_tpu.engine.shaders import pathtrace_closest
            return ShaderTable(closest=pathtrace_closest)
        return self.table

    def render_burst(self, cam: Camera, params: RenderParams,
                     width: Optional[int] = None,
                     height: Optional[int] = None,
                     n_frames: int = 16, seed0: int = 0,
                     rays_only: bool = False):
        """Render ``n_frames`` frames in one dispatch (seeds advance per
        frame); returns (last image, total rays).  The sustained-throughput
        / animation API — see render_burst (module level).

        ``rays_only=True`` skips the image render and readback and
        returns only the ray count — benchmark loops pull the image once,
        after timing."""
        w = width or self.config.width
        h = height or self.config.height
        ca, light = self._dev_args(cam, params)
        nrays = render_burst(
            self.wa, self.sa, ca, light, w, h, n_frames=n_frames,
            seed0=seed0, max_depth=params.max_depth, spp=params.spp,
            chunk=self.config.lanes, table=self._table_for(params),
            packet=self.config.packet_size,
            tile_w=self.config.tile_w, tile_h=self.config.tile_h,
            shadow=params.shadow,
            bounce_packet=self.config.bounce_packet,
            shadow_packet=self.config.shadow_packet,
            bounce_fronts=self.config.bounce_fronts,
            bounce_sort_seg=self.config.bounce_sort_seg,
            slab=self.config.slab)
        if rays_only:
            return int(nrays)
        # the burst program is scalar-only; the last frame's image comes
        # from the separate single-frame program
        img, _ = self.render(cam, params, w, h)
        return img, int(nrays)

    def perf_trace(self, cam: Camera, params: RenderParams,
                   width: Optional[int] = None,
                   height: Optional[int] = None) -> dict:
        """WHOLE-FRAME divergence profile (the RTU PerfStats analog,
        rt_unit.h:15-45): one frame with PacketStats carried through
        every wave — primary trace, per-bounce traces, shadow occlusion
        waves — returning per-wave loop iterations, live-packet steps,
        live-ray steps, and node-kind mix (VERDICT r2 weak #4: the
        shipped tracer now covers the full frame, not just the primary
        wave).  Diagnostic path — compiled separately from the render
        programs."""
        w = width or self.config.width
        h = height or self.config.height
        ca, light = self._dev_args(cam, params)
        rays, steps, wstats = render_stats(
            self.wa, self.sa, ca, light, w, h,
            max_depth=params.max_depth, spp=params.spp,
            chunk=self.config.lanes, table=self._table_for(params),
            packet=self.config.packet_size, shadow=params.shadow,
            tile_w=self.config.tile_w, tile_h=self.config.tile_h,
            bounce_packet=self.config.bounce_packet,
            shadow_packet=self.config.shadow_packet,
            bounce_fronts=self.config.bounce_fronts,
            bounce_sort_seg=self.config.bounce_sort_seg,
            slab=self.config.slab)
        out = dict(rays=int(rays), steps=int(steps),
                   packet_size=self.config.packet_size)
        for name in sorted(wstats):
            st = jax.tree.map(int, wstats[name])
            out[name] = dict(
                steps=st.steps, packet_steps=st.packet_steps,
                ray_steps=st.ray_steps,
                rays_per_live_packet=round(
                    st.ray_steps / max(st.packet_steps, 1), 2),
                int_steps=st.int_steps, tri_steps=st.tri_steps,
                ins_steps=st.ins_steps)
        return out

    def frame_profile(self, cam: Camera, params: RenderParams,
                      width: Optional[int] = None,
                      height: Optional[int] = None,
                      n_frames: int = 8) -> list:
        """Wall-clock ms attribution per wave: times stage-truncated
        bursts (camera -> +trace0 -> +shadow0 -> +shade0 -> +trace1 ...)
        and reports the deltas — one command reproduces the frame-budget
        breakdown round 2 derived from scratch scripts (VERDICT r2
        next-round #5).  Each stage is its own program: expect a compile
        per stage on first use."""
        import time as _time

        w = width or self.config.width
        h = height or self.config.height
        ca, light = self._dev_args(cam, params)
        table = self._table_for(params)
        labels = ["camera"]
        for k in range(params.max_depth):
            labels.append(f"trace{k}")
            if params.shadow:
                labels.append(f"shadow{k}")
            labels.append(f"shade{k}")

        def run(limit, seed0):
            return int(render_profile_burst(
                self.wa, self.sa, ca, light, w, h, n_frames=n_frames,
                seed0=seed0, max_depth=params.max_depth, spp=params.spp,
                chunk=self.config.lanes, table=table,
                packet=self.config.packet_size, shadow=params.shadow,
                tile_w=self.config.tile_w, tile_h=self.config.tile_h,
                stage_limit=limit,
                bounce_packet=self.config.bounce_packet,
                shadow_packet=self.config.shadow_packet,
                bounce_fronts=self.config.bounce_fronts,
                bounce_sort_seg=self.config.bounce_sort_seg,
                slab=self.config.slab))

        stage_ids = []
        for lab in labels:
            if lab == "camera":
                stage_ids.append(0)
            else:
                k = int(lab[-1])
                op = {"trace": 1, "shadow": 2, "shade": 3}[lab[:-1]]
                stage_ids.append(op + 3 * k)
        out = []
        prev_ms = 0.0
        for lab, sid in zip(labels, stage_ids):
            run(sid, 0)  # compile + warm
            t0 = _time.perf_counter()
            run(sid, n_frames)
            ms = (_time.perf_counter() - t0) * 1e3 / n_frames
            out.append(dict(stage=lab, cum_ms=round(ms, 2),
                            ms=round(ms - prev_ms, 2)))
            prev_ms = ms
        return out

    def scope_trace(self, cam: Camera, params: RenderParams,
                    width: Optional[int] = None,
                    height: Optional[int] = None,
                    n_frames: int = 4):
        """Frame logic-analyzer view (the scope analog,
        runtime/common/scope.cpp:37-216: drain signal taps -> VCD).
        Drains BOTH observability surfaces into one Perfetto timeline:
        ``frame_profile``'s per-stage wall-clock ms become spans on a
        synthetic frame timeline, and ``perf_trace``'s per-wave
        PerfStats become counter tracks (loop iterations, live-packet /
        live-ray steps, occupancy, node-kind mix) stepped at each
        wave's span — so the divergence counters line up under the ms
        budget they explain.  Returns a ``Tracer``; call ``.save(path)``
        and load in ui.perfetto.dev or chrome://tracing.

        Diagnostic path: compiles one program per stage (frame_profile)
        plus the stats frame (perf_trace) on first use."""
        from vortex_rt_tpu.utils.trace import Tracer

        tr = Tracer()
        prof = self.frame_profile(cam, params, width, height,
                                  n_frames=n_frames)
        stats = self.perf_trace(cam, params, width, height)
        tr.instant("frame", rays=stats.get("rays"),
                   steps=stats.get("steps"),
                   packet_size=stats.get("packet_size"))
        t = 0.0
        for row in prof:
            dur = max(float(row["ms"]), 0.0) * 1e3  # us
            st = stats.get(row["stage"])
            tr.complete_at(row["stage"], t, dur, **(st or {}))
            if st:
                # counter tracks step at the wave's start so the
                # sawtooth under the span shows which wave spent what
                tr.counter_at("loop_iterations", t, value=st["steps"])
                tr.counter_at("live_packet_steps", t,
                              value=st["packet_steps"])
                tr.counter_at("live_ray_steps", t, value=st["ray_steps"])
                tr.counter_at("rays_per_live_packet", t,
                              value=st["rays_per_live_packet"])
                tr.counter_at("node_kind_mix", t,
                              internal=st["int_steps"],
                              triangle=st["tri_steps"],
                              instance=st["ins_steps"])
            t += dur
        return tr

    def render_accum(self, cam: Camera, params: RenderParams,
                     width: Optional[int] = None,
                     height: Optional[int] = None,
                     n_passes: int = 4, seed0: int = 0):
        """Progressive high-spp render: averages ``n_passes`` frames of
        ``params.spp`` samples each (stratified over the product) in one
        dispatch — the scale-friendly way to hit BASELINE configs 3-4's
        4/8 spp without multiplying pool memory.  Returns (image, rays)."""
        w = width or self.config.width
        h = height or self.config.height
        ca, light = self._dev_args(cam, params)
        img, nrays, _ = render_accum(
            self.wa, self.sa, ca, light, w, h, n_passes=n_passes,
            seed0=seed0, max_depth=params.max_depth, spp=params.spp,
            chunk=self.config.lanes, table=self._table_for(params),
            packet=self.config.packet_size,
            tile_w=self.config.tile_w, tile_h=self.config.tile_h,
            shadow=params.shadow,
            bounce_packet=self.config.bounce_packet,
            shadow_packet=self.config.shadow_packet,
            bounce_fronts=self.config.bounce_fronts,
            bounce_sort_seg=self.config.bounce_sort_seg,
            slab=self.config.slab)
        return np.asarray(img), int(nrays)

    def _render_chunked(self, cam: Camera, params: RenderParams,
                        w: int, h: int) -> Tuple[np.ndarray, int]:
        chunk = self.config.lanes
        light = LightArrays.from_params(params)
        (ox, oy, oz, dx, dy, dz, pix, slot, alive) = _gen_pool(
            CameraArrays.from_camera(cam), w, h, params.spp, chunk)
        r = ox.shape[0]
        c = r // chunk
        rad_r = jnp.zeros(r, jnp.float32)
        rad_g = jnp.zeros(r, jnp.float32)
        rad_b = jnp.zeros(r, jnp.float32)
        thr = jnp.ones(r, jnp.float32)
        bounce_ct = jnp.zeros(r, jnp.int32)
        nrays = 0
        n_alive = int(np.asarray(alive.sum()))

        for bounce in range(params.max_depth):
            if bounce > 0:
                with maybe_span("compact", bounce=bounce, alive=n_alive):
                    (ox, oy, oz, dx, dy, dz, alive, rad_r, rad_g, rad_b, thr,
                     bounce_ct, pix, slot) = _compact_pool(
                        ox, oy, oz, dx, dy, dz, alive, rad_r, rad_g, rad_b,
                        thr, bounce_ct, pix, slot)
            nrays += n_alive
            n_chunks = min(c, (n_alive + chunk - 1) // chunk)
            if n_chunks == 0:
                break
            chunks = _split_pool(ox, oy, oz, dx, dy, dz, alive, chunk)
            with maybe_span("trace", bounce=bounce, chunks=n_chunks):
                outs = [
                    _trace_chunk_jit(self.wa, *chunks[i])
                    for i in range(n_chunks)
                ]
            z = jnp.zeros(chunk, jnp.float32)
            zi = jnp.zeros(chunk, jnp.int32)
            big = jnp.full(chunk, LARGE_FLOAT)
            pads = [(big, z, z, zi, zi, jnp.int32(0))] * (c - n_chunks)
            allouts = outs + pads
            dist = jnp.concatenate([o[0] for o in allouts])
            bx = jnp.concatenate([o[1] for o in allouts])
            by = jnp.concatenate([o[2] for o in allouts])
            tri = jnp.concatenate([o[3] for o in allouts])
            inst = jnp.concatenate([o[4] for o in allouts])
            with maybe_span("shade", bounce=bounce):
                (ox, oy, oz, dx, dy, dz, alive, rad_r, rad_g, rad_b, thr,
                 bounce_ct) = _shade_pool_default(
                    self.sa, light, params.max_depth,
                    ox, oy, oz, dx, dy, dz, alive,
                    dist, bx, by, tri, inst,
                    rad_r, rad_g, rad_b, thr, bounce_ct, pix)
            if bounce + 1 < params.max_depth:
                n_alive = int(np.asarray(alive.sum()))

        img = _resolve(rad_r, rad_g, rad_b, slot, w * h, params.spp,
                       w * h * params.spp)
        return np.asarray(img).reshape(h, w, 3), int(nrays)
