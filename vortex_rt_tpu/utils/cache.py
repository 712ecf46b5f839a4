"""Persistent XLA compilation cache placement.

The frame programs take tens of seconds or more to compile at scale, and
an identical program found on disk loads in seconds.  The cache lives in
``JAX_COMPILATION_CACHE_DIR`` when that is set, and otherwise in one
fixed directory inside the checkout (``<repo>/.jax_cache``, git-ignored).
A fixed path is what lets a later process find what an earlier one
compiled, so the directory is never derived from a pid, a time or a
temp dir.
"""

from __future__ import annotations

import os
from typing import Mapping

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")

_enabled = False


def resolve_cache_dir(env: Mapping[str, str]) -> str:
    """Cache directory for environment ``env``: ``JAX_COMPILATION_CACHE_DIR``
    if set and non-empty, else the fixed in-checkout ``DEFAULT_DIR``."""
    return env.get(ENV_VAR) or DEFAULT_DIR


def enable_persistent_cache() -> str:
    """Idempotently point JAX at the on-disk compilation cache.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it; the
    directory is left as JAX configured it and only the size/time
    thresholds are lowered so every program is cached."""
    global _enabled
    import jax

    path = resolve_cache_dir(os.environ)
    if not _enabled:
        os.makedirs(path, exist_ok=True)
        if ENV_VAR not in os.environ or not os.environ[ENV_VAR]:
            jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
        _enabled = True
    return path
