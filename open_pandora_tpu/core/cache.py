"""Persistent XLA compilation cache.

Every entry point (pipeline CLI, trainer, bench.py, chip_smoke.py) enables
it through `enable_compilation_cache`. Where JAX_COMPILATION_CACHE_DIR is
set, JAX reads it itself and this function sets no other directory;
otherwise the cache sits at `<repo>/.jax_cache` (listed in .gitignore).
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """The directory the compile cache uses."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO_ROOT, ".jax_cache"))


def enable_compilation_cache() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
