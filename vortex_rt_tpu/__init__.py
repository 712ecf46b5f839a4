"""vortex_rt_tpu — a wavefront path tracer in JAX.

A ground-up JAX/XLA re-design of the capabilities of the
LazyLatte/vortex-raytracing reference (a Vortex RISC-V GPGPU fork whose simx
simulator adds a hardware ray-tracing unit).  Instead of simulating a GPU, we
map the reference's render loop onto array programs that XLA compiles for
the accelerator (an NVIDIA H100; CPU for tests):

  * scene/asset pipeline (OBJ + MTL + textures)         -> ``io``, ``models``
  * binned-SAH binary BVH + 4-wide quantized TLAS/BLAS  -> ``accel``
  * traceRay / BVH traversal / Moller-Trumbore          -> ``ops`` (jit)
  * RTU shader queues (miss/closest/any-hit regrouping) -> ``engine.wavefront``
  * host driver / DCR config                            -> ``runtime``
  * multi-core tiling -> multi-chip ``shard_map``       -> ``parallel``
  * raycast ``-c`` CPU golden renderer                  -> ``golden``

Reference layer map: see SURVEY.md section 1; component parity: SURVEY.md
section 2 (each module docstring cites the reference file:line it mirrors).
"""

__version__ = "0.1.0"

from vortex_rt_tpu.utils.config import RTConfig  # noqa: F401
