"""Persistent compile-cache rule (sequila_tpu/_jaxcache.py).

JAX_COMPILATION_CACHE_DIR, when set, is the cache and the package sets
no other directory; unset, the cache is one fixed, git-ignored directory
inside the checkout.
"""

import os
import subprocess
import sys
from pathlib import Path

from sequila_tpu import _jaxcache

REPO = Path(__file__).resolve().parents[1]


def test_env_dir_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert _jaxcache.cache_dir_to_set() is None


def test_default_is_fixed_ignored_dir_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = _jaxcache.cache_dir_to_set()
    assert first == _jaxcache.cache_dir_to_set() == str(REPO / ".jax_cache")
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def _cache_dir_after_import(env_dir):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, sequila_tpu; print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120, check=True,
    )
    return out.stdout.strip().splitlines()[-1]


def test_import_honours_env_dir(tmp_path):
    assert _cache_dir_after_import(str(tmp_path)) == str(tmp_path)


def test_import_without_env_uses_checkout_dir():
    assert _cache_dir_after_import(None) == str(REPO / ".jax_cache")
