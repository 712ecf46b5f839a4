"""chip_smoke.py on the CPU: it refuses to run without a GPU, its last
line has exactly the contract's keys, and every phase function passes
its own parity checks at toy size (the card runs them at full size)."""

import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def test_refuses_cpu_device():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=str(ROOT), env=env, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_result_line_has_exactly_the_contract_keys():
    line = chip_smoke.result_line(dict(platform="gpu", kind="NVIDIA H100",
                                       count=1, extra="dropped"))
    obj = json.loads(line)
    assert obj == {"ok": True, "device": {"platform": "gpu",
                                         "kind": "NVIDIA H100",
                                         "count": 1}}
    assert "\n" not in line


@pytest.mark.parametrize("phase,kwargs", [
    ("main", dict(model="cornell", w=32, h=32)),
    ("build", dict(ploc_model="sphere", lbvh_model="sphere", w=32, h=32)),
    ("anyhit", dict(model="cornell", w=32, h=32)),
    ("megakernel", dict(model="cornell", w=32, h=32)),
])
def test_phase_at_toy_size(phase, kwargs):
    out = getattr(chip_smoke, f"phase_{phase}")(**kwargs)
    assert out is not None


def test_main_phase_reports_every_metric():
    out = chip_smoke.phase_main(model="cornell", w=32, h=16)
    for key in ("compile_s", "ms_per_frame", "mrays_per_s",
                "iterations_per_frame", "ms_per_iteration", "parity_rmse"):
        assert np.isfinite(out[key]), key
    assert out["iterations_per_frame"] > 0
    assert out["parity_rmse"] < chip_smoke.PARITY_RMSE


def test_multi_phase_on_four_virtual_devices():
    devs = jax.devices()[:4]
    assert len(devs) == 4
    chip_smoke.phase_multi(devs, model="cornell", w=32, h=32)


def test_ladder_refuses_to_spawn_from_a_jax_process():
    """One process per card: the CLI's --ladder child would need the
    card this (already initialised) JAX process holds, so it refuses
    before spawning anything."""
    from vortex_rt_tpu import cli

    jax.devices()  # this process now holds a backend
    with pytest.raises(SystemExit) as e:
        cli.main(["--ladder", "1"])
    assert e.value.code == 2
