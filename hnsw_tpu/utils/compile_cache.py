"""Persistent XLA compile cache.

Every program of the search path compiles once per shape; a process that
starts cold (a fresh service, a benchmark run) pays all of it again unless
JAX keeps compiled programs on disk. The cache key includes the directory,
so the directory must be fixed: never temporary, per-process or dated.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    If `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and nothing
    is set here; otherwise the cache is `<repo>/.jax_cache`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
