"""Test harness config.

Tests run on a virtual 8-device CPU mesh so multi-device sharding paths are
exercised without accelerator hardware (the analog of the reference running the same
app across simx/rtlsim backends via VORTEX_DRIVER, raytracing/Makefile:127-130).
Must set XLA flags before jax is imported anywhere.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

# persistent compile cache: the suite compiles dozens of big traversal
# programs (minutes each cold on a small CPU host); identical HLO on later
# runs loads from disk instead (utils/cache.py — same mechanism the
# benchmark uses)
from vortex_rt_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

# ---- full-suite stability: drop live executables at module boundaries.
# A single process that accumulates every compiled program of the whole
# suite segfaults inside jax's persistent-cache DESERIALIZATION at a
# consistent point (~154/177 tests, jax 0.9.0
# compilation_cache.get_executable_and_time -> backend
# .deserialize_executable, reproduced 3/3 full runs in round 4/5 while
# every subset passes) — process-cumulative XLA:CPU client state, not a
# poisoned entry.  Releasing the live executables between modules keeps
# the client below the crash threshold; later modules reload what they
# need from the disk cache (seconds, not the minutes a recompile
# costs).  VORTEX_RT_NO_CLEAR=1 disables (to reproduce the crash);
# VORTEX_RT_SUITE_DEBUG=1 logs per-module process resource counters.
_last_module = [None]


def pytest_runtest_setup(item):
    mod = getattr(item, "module", None)
    name = getattr(mod, "__name__", None)
    if (_last_module[0] is not None and name != _last_module[0]
            and os.environ.get("VORTEX_RT_NO_CLEAR") != "1"):
        jax.clear_caches()
    if (name != _last_module[0]
            and os.environ.get("VORTEX_RT_SUITE_DEBUG") == "1"):
        try:
            import resource

            n_maps = sum(1 for _ in open("/proc/self/maps"))
            n_fds = len(os.listdir("/proc/self/fd"))
            n_thr = sum(1 for ln in open("/proc/self/status")
                        if ln.startswith("Threads:"))
            thr = [ln.split()[1] for ln in open("/proc/self/status")
                   if ln.startswith("Threads:")]
            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            print(f"\n[suite-debug] {name}: maps={n_maps} fds={n_fds} "
                  f"threads={thr[0] if thr else n_thr} maxrss_mb="
                  f"{rss // 1024}", flush=True)
        except Exception:
            pass
    _last_module[0] = name


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
