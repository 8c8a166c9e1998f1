"""JAX's persistent compilation cache, at one fixed place.

Every entry point (``nbodyax.cli``, ``bench.py``, ``chip_smoke.py``) calls
``enable_compile_cache`` before it compiles anything. Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is set
here. Otherwise the cache goes to ``.jax_cache/`` at the root of the checkout
(git-ignored): a fixed path, because the path is part of the cache's key and
a directory that moves never hits.
"""

from __future__ import annotations

import os

import jax

__all__ = ["enable_compile_cache", "DEFAULT_CACHE_DIR"]

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
