"""Compilation-cache placement (utils/cache.py).

``JAX_COMPILATION_CACHE_DIR`` wins when set; otherwise the cache is one
fixed directory inside the checkout, the same in every call and every
process, so a later process finds what an earlier one compiled.
"""

import os
import pathlib
import subprocess
import sys

import pytest

from vortex_rt_tpu.utils import cache

ROOT = pathlib.Path(__file__).resolve().parents[1]

# prints the cache dir JAX was left with after enable_persistent_cache()
# and compiles one tiny program so the cache gets an entry
_PROBE = """
import jax, jax.numpy as jnp
from vortex_rt_tpu.utils.cache import enable_persistent_cache
enable_persistent_cache()
jax.jit(lambda x: x * 3 + 1)(jnp.arange(7)).block_until_ready()
print(jax.config.jax_compilation_cache_dir)
"""


def _probe_env(**over):
    env = {k: v for k, v in os.environ.items()
           if k != cache.ENV_VAR}
    env.update(JAX_PLATFORMS="cpu", **over)
    return env


def _run_probe(env):
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("value", ["/data/xla-cache", "rel/cache"])
def test_env_var_is_honoured(value):
    assert cache.resolve_cache_dir({cache.ENV_VAR: value}) == value


@pytest.mark.parametrize("env", [{}, {cache.ENV_VAR: ""},
                                 {"HOME": "/elsewhere", "TMPDIR": "/t"}])
def test_default_is_fixed_in_checkout(env):
    path = cache.resolve_cache_dir(env)
    assert path == cache.DEFAULT_DIR
    assert pathlib.Path(path) == ROOT / ".jax_cache"
    # stable across calls
    assert cache.resolve_cache_dir(dict(env)) == path


def test_default_is_git_ignored():
    lines = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in lines


def test_default_is_the_same_in_another_process():
    out = subprocess.run(
        [sys.executable, "-c",
         "from vortex_rt_tpu.utils.cache import resolve_cache_dir;"
         "print(resolve_cache_dir({}))"],
        cwd=str(ROOT), env=_probe_env(), capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == cache.DEFAULT_DIR


def test_cache_lands_in_env_dir(tmp_path):
    """With the variable set, the entries land there and the code sets
    no other directory."""
    target = tmp_path / "xla"
    got = _run_probe(_probe_env(**{cache.ENV_VAR: str(target)}))
    assert got == str(target)
    assert any(target.iterdir()), "no cache entry written"


def test_cache_defaults_to_checkout_dir():
    got = _run_probe(_probe_env())
    assert got == cache.DEFAULT_DIR
    assert any(pathlib.Path(got).iterdir())
