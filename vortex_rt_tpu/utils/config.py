"""Framework configuration.

JAX analog of the reference's two-TOML config system
(``hw/VX_config.toml`` arch knobs + ``hw/VX_types.toml`` address map, compiled
by ``ci/gen_config.py``).  Knob names mirror the reference where a concept
carries over (RT_BVH_WIDTH / RT_STACK_SIZE / trail depth / lanes / queue
capacity, ``hw/VX_config.toml:244-247``, ``sim/simx/rt_traversal.h:9-10``);
the reference GPU's own knobs (warps, cache geometry) are replaced by
array-program ones (ray-batch lanes, tile size, wave count, mesh axes).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

# Sentinel "no hit" distance; reference uses LARGE_FLOAT
# (tests/regression/raytracing/geometry.h ray_t.dist init).
LARGE_FLOAT = 1e30

# Moller-Trumbore epsilon, matching the reference exactly
# (sim/simx/rt_traversal.cpp:263-316 EPSILON 1e-6).
MT_EPSILON = 1e-6

# Shader/work types, matching RTUnit's ShaderType enum order
# (sim/simx/rt_unit.cpp:10 ShaderType{MISS, CLOSET, INTERSECTION, ANY}).
SHADER_MISS = 0
SHADER_CLOSEST = 1
SHADER_INTERSECTION = 2  # reserved (procedural prims), unused by reference apps
SHADER_ANY = 3
NUM_SHADER_TYPES = 4

# Commit actions, matching VX_RT_COMMIT_* (hw/VX_types.toml:270-285 and
# sim/simx/rt_unit.cpp:190-213 semantics).
COMMIT_CONT = 0    # reject pending hit, resume traversal
COMMIT_ACCEPT = 1  # accept pending hit (dist = pending_dist), resume traversal
COMMIT_TERM = 2    # terminate ray, free all per-ray state


@dataclasses.dataclass(frozen=True)
class RTConfig:
    """All static knobs of the tracer.  Frozen so it can key jit caches."""

    # ---- acceleration structure (reference hw/VX_config.toml:244-247) ----
    bvh_width: int = 0          # RT_BVH_WIDTH: children per wide-BVH node
                                # (4 or 8; 8 requires flatten=True).
                                # 0 = auto: 8 on flattened builds, else 4
                                # (ARCHITECTURE.md rule 29)
    stack_size: int = 5         # RT_STACK_SIZE: short-stack entries per ray
    max_trail: int = 32         # MAX_TRAIL_LEVEL (sim/simx/rt_traversal.h:9)
    sah_bins: int = 8           # BINS in binned SAH build (bvh.cpp:135-191)
    max_leaf_tris: int = 4      # leaf size target for the binary BVH
    use_native_build: bool = True  # csrc/ C++ builder when available
    fused_rows: bool = True     # single-gather node+leaf rows on
                                # flattened builds (WideArrays.fuse;
                                # ARCHITECTURE.md rule 29).  Ignored on
                                # TLAS builds; env VORTEX_RT_FUSED_ROWS=0/1
                                # overrides (sweep harnesses)
    flatten: bool = False       # build ONE world-space BVH over all
                                # instances (transforms baked at build,
                                # leaf ids packed (inst<<bits)|tri): no
                                # instance nodes, no local-space lanes in
                                # the packet loop (less loop state, fewer
                                # steps).  Static scenes only;
                                # per-instance materials and hit ids are
                                # preserved exactly

    # ---- wavefront engine (RTU analog) ----
    lanes: int = 32768          # rays per traversal group (NUM_RTU_LANES
                                # analog) for the per-ray engine's chunks
    packet_size: int = 256      # rays per traversal packet (0 = per-ray
                                # engine); packets share one node walk, so
                                # coherent waves amortize the walk over
                                # more rays (one 16x16 pixel tile each)
    bounce_packet: int = 16     # packet size for bounce (k>0) waves:
                                # diffuse-bounce directions are incoherent
                                # and a packet walks its rays' UNION path,
                                # so bounce waves want tighter packets
                                # (0 = per-ray engine for bounce waves).
                                # Swept jointly with slab (rule 34): a
                                # slab of S lanes runs S/bp packets per
                                # loop iteration
    bounce_fronts: int = 0      # stack nodes walked per packet per loop
                                # iteration on incoherent (k>0) waves
                                # (trace_packets fronts; flat builds
                                # only): F fronts drain the shared
                                # per-packet stack F nodes at a time in
                                # one (F*B,)-row gather, with bit-
                                # identical hits.  0 = auto: env
                                # VORTEX_RT_FRONTS or 2 (rule 34)
    slab: int = 0               # rays per streamed frame slab (frame_body
                                # slab-major loop).  Sets the while-loop
                                # gather batch: a slab of S lanes at
                                # bounce_packet P runs S/P packets per
                                # loop iteration.  Bounded by loop-state
                                # memory (~200 B/lane) and by the
                                # straggler max (one while_loop iterates
                                # for its slowest packet).  0 = auto: env
                                # VORTEX_RT_SLAB or 131072 (rule 34)
    bounce_sort_seg: int = -1   # SEGMENTED direction-octant regrouping
                                # of incoherent (k>0) bounce waves:
                                # stable-sort wave lanes by
                                # (lane//seg) << 4 | octant (dead lanes
                                # keyed last) before packetization, and
                                # scatter hits back after.  Packets
                                # become direction-pure while origins
                                # stay within an N-lane tile window.
                                # Bit-identical (packet composition
                                # only).  0 = off; -1 = auto: env
                                # VORTEX_RT_SORT_SEG or 0 (rule 38)
    shadow_packet: Optional[int] = None  # packet size for shadow
                                # occlusion waves; None follows each
                                # bounce's wave packet (primary-size at
                                # bounce 0, bounce_packet after)
    queue_capacity: int = 1024  # ShaderQueue CAPACITY (sim/simx/types.h:1844)
                                # — enforced by the RTU facade: bounded
                                # queues with lossless overflow spill

    # ---- render parameters (kernel_arg_t analog, raytracing/common.h:164) ----
    width: int = 256
    height: int = 256
    spp: int = 1
    max_depth: int = 2          # bounce budget (reference -d flag)
    tex_filter: str = "point"   # 'point' (texSample) or 'bilinear'
                                # (texSampleBi, raycast/render.h:8-56)
    tile_w: int = 16            # pixel tile per packet (the reference maps
    tile_h: int = 16            # 8x8 blocks to cores, kernel.cpp:128-133;
                                # tile_w*tile_h should equal packet_size;
                                # frame_body adapts tile_h down (8/4/2)
                                # when the frame height doesn't divide)

    # ---- numerics ----
    epsilon: float = MT_EPSILON
    t_max: float = LARGE_FLOAT

    # ---- multi-chip ----
    mesh_axes: Tuple[str, ...] = ("tiles",)

    def __post_init__(self):
        if self.bounce_fronts == 0:
            import os
            object.__setattr__(
                self, "bounce_fronts",
                max(int(os.environ.get("VORTEX_RT_FRONTS", "2")), 1))
        if self.slab == 0:
            import os
            object.__setattr__(
                self, "slab",
                max(int(os.environ.get("VORTEX_RT_SLAB", "131072")), 1024))
        if self.bounce_sort_seg < 0:
            import os
            object.__setattr__(
                self, "bounce_sort_seg",
                int(os.environ.get("VORTEX_RT_SORT_SEG", "0")))
        if self.bvh_width == 0:
            # auto: 8-wide needs the flattened build's packed leaf ids;
            # suspension/TLAS pipelines keep the 4-wide instance rows
            object.__setattr__(self, "bvh_width", 8 if self.flatten else 4)
        assert self.bvh_width in (4, 8, 16), \
            f"bvh_width must be 4, 8 or 16, got {self.bvh_width}"
        assert self.bvh_width == 4 or self.flatten, \
            "bvh_width>4 requires flatten=True (no instance-node rows)"
        # 16 is an experimental packet-engine capability (host builds
        # only; not adopted, see ARCHITECTURE.md rule 38)
        assert self.max_leaf_tris >= 1

    def replace(self, **kw: Any) -> "RTConfig":
        return dataclasses.replace(self, **kw)

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def from_overrides(base: Optional[RTConfig] = None, **kw: Any) -> RTConfig:
    """CONFIGS="-DNAME=val"-style overrides (ci/gen_config.py analog)."""
    return (base or RTConfig()).replace(**kw)
