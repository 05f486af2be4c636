"""Persistent XLA compilation cache, enabled on package import.

Compiled executables are reused across processes (CLI runs, notebooks,
the bench's sections, chip_smoke.py).  Role analog of the reference
relying on cargo's build cache for its ahead-of-time native kernels —
here compilation happens at run time, so the cache must too.

``JAX_COMPILATION_CACHE_DIR``, when set, names the cache and JAX reads it
itself; nothing here overrides it.  Otherwise the cache lives at a fixed
directory inside the checkout (``.jax_cache/``, git-ignored): the path
is part of what a later process must find again, so it never depends on
a temporary name, a pid or the time.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)

_done = False


def cache_dir_to_set() -> str | None:
    """The directory this package sets, or None when the environment
    already names one through JAX_COMPILATION_CACHE_DIR."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return REPO_CACHE_DIR


def setup_jax_compilation_cache() -> None:
    global _done
    if _done:
        return
    _done = True
    import jax

    cache_dir = cache_dir_to_set()
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
