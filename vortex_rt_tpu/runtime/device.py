"""Host runtime / driver API — the vortex.h analog (L5).

The reference exposes a C driver API (runtime/include/vortex.h): vx_dev_open
:80, vx_mem_alloc :89, vx_copy_to_dev :107, vx_start :113, vx_ready_wait
:116, vx_dcr_write :122, vx_upload_kernel_file :133, vx_dump_perf :145 —
with selectable backends (simx / rtlsim / FPGA) behind one interface.

This module wraps the JAX runtime with the same surface:

* backends = JAX platforms (``cpu`` = the "simulator" backend, ``gpu`` =
  the accelerator), selected at open() like VORTEX_DRIVER selects a
  driver.  Opening a backend the host does not have raises DeviceError:
  there is no silent fallback to another platform;
* mem_alloc / copy_to_dev = tracked jax.device_put allocations;
* dcr_write = a device-configuration register file.  The RT-relevant DCRs
  mirror hw/VX_types.toml:16-19 (RTX TLAS/BLAS/BVH/TRI base "pointers" —
  here, names of bound buffers);
* upload_kernel = registering shader entry points (the vxbin/SBT analog);
* start / ready_wait = async dispatch + block_until_ready;
* dump_perf = MPM-style counter report (vx_dump_perf analog).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import jax
import numpy as np

# DCR address map (hw/VX_types.toml:16-19)
VX_DCR_BASE_STARTUP_ADDR = 0x001
VX_DCR_BASE_MPM_CLASS = 0x005
VX_DCR_BASE_RTX_TLAS_PTR = 0x006
VX_DCR_BASE_RTX_BLAS_PTR = 0x007
VX_DCR_BASE_RTX_BVH_PTR = 0x008
VX_DCR_BASE_RTX_TRI_PTR = 0x009


# JAX platforms dev_open accepts (VORTEX_DRIVER analog)
BACKENDS = ("cpu", "gpu")


class DeviceError(RuntimeError):
    pass


class Device:
    """One accelerator context (vx_device analog, runtime/simx/vortex.cpp:49)."""

    def __init__(self, backend: Optional[str] = None):
        if backend is not None and backend not in BACKENDS:
            raise DeviceError(
                f"unknown backend {backend!r} (expected one of {BACKENDS})")
        try:
            self._device = jax.devices(backend)[0]
        except RuntimeError as e:
            raise DeviceError(f"cannot open backend {backend!r}: {e}") from e
        self._buffers: Dict[str, jax.Array] = {}
        self._dcrs: Dict[int, Any] = {}
        self._kernels: Dict[str, Callable] = {}
        self._pending: Optional[Any] = None
        self._counters: Dict[str, float] = {
            "uploads": 0, "bytes_to_dev": 0, "bytes_from_dev": 0,
            "kernels_launched": 0, "rays_traced": 0, "device_time_s": 0.0,
        }

    # ---- memory (vx_mem_alloc / vx_copy_to_dev / vx_copy_from_dev) ----

    def copy_to_dev(self, name: str, host: np.ndarray) -> jax.Array:
        arr = jax.device_put(np.asarray(host), self._device)
        self._buffers[name] = arr
        self._counters["uploads"] += 1
        self._counters["bytes_to_dev"] += arr.nbytes
        return arr

    def buffer(self, name: str) -> jax.Array:
        if name not in self._buffers:
            raise DeviceError(f"no buffer named {name!r}")
        return self._buffers[name]

    def copy_from_dev(self, arr) -> np.ndarray:
        out = np.asarray(arr)
        self._counters["bytes_from_dev"] += out.nbytes
        return out

    def mem_info(self) -> Dict[str, int]:
        """vx_mem_info analog: allocation footprint per buffer."""
        return {k: v.nbytes for k, v in self._buffers.items()}

    # ---- configuration registers (vx_dcr_write) ----

    def dcr_write(self, addr: int, value: Any) -> None:
        self._dcrs[addr] = value

    def dcr_read(self, addr: int) -> Any:
        if addr not in self._dcrs:
            raise DeviceError(f"DCR 0x{addr:03x} not written")
        return self._dcrs[addr]

    # ---- kernels (vx_upload_kernel_* / SBT) ----

    def upload_kernel(self, name: str, fn: Callable) -> None:
        """Register an entry point (the vxbin upload analog: the reference
        reserves each shader binary at its linked VMA; we key by name)."""
        self._kernels[name] = fn

    # ---- execution (vx_start / vx_ready_wait) ----

    def start(self, kernel: str, *args, **kw) -> None:
        """Launch asynchronously (JAX dispatch is async, like the simx
        driver's std::async(processor.run()))."""
        if self._pending is not None:
            raise DeviceError("device busy (vx_start while running)")
        fn = self._kernels.get(kernel)
        if fn is None:
            raise DeviceError(f"kernel {kernel!r} not uploaded")
        self._t0 = time.perf_counter()
        self._pending = fn(*args, **kw)
        self._counters["kernels_launched"] += 1

    def ready_wait(self, timeout_s: Optional[float] = None):
        """Block until the launched kernel completes (vx_ready_wait).
        The JAX runtime has no preemptive timeout; a timeout that expires
        after completion checking raises like the reference's -1 return."""
        if self._pending is None:
            raise DeviceError("nothing running")
        out = self._pending
        jax.block_until_ready(out)
        dt = time.perf_counter() - self._t0
        self._counters["device_time_s"] += dt
        if timeout_s is not None and dt > timeout_s:
            self._pending = None
            raise DeviceError(f"ready_wait exceeded {timeout_s}s ({dt:.3f}s)")
        self._pending = None
        return out

    # ---- observability (vx_dump_perf / MPM counters) ----

    def add_counter(self, name: str, value: float) -> None:
        self._counters[name] = self._counters.get(name, 0) + value

    def dump_perf(self) -> Dict[str, float]:
        report = dict(self._counters)
        report["buffers"] = len(self._buffers)
        report["buffer_bytes"] = float(sum(self.mem_info().values()))
        return report

    @property
    def platform(self) -> str:
        return self._device.platform


def card_info() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``name, power.limit`` per line), or ``"not available"`` where the
    tool is absent.  Every device timing is reported beside this line: a
    card set below its maximum power runs slower under load."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return out.stdout.strip() or "not available"


def require_accelerator() -> Dict[str, Any]:
    """The device a measurement runs on, as JAX reports it; raises
    DeviceError when JAX found no GPU.  Measurement paths call this
    first so that no number is ever taken on a CPU fallback."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise DeviceError(
            f"no GPU found: JAX platform is {devs[0].platform!r}")
    return dict(platform=devs[0].platform, kind=devs[0].device_kind,
                count=len(devs))


def dev_open(backend: Optional[str] = None) -> Device:
    """vx_dev_open analog; backend like VORTEX_DRIVER: 'cpu', 'gpu', or
    None for JAX's default platform."""
    return Device(backend)
