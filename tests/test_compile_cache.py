"""The persistent compile-cache helper follows JAX_COMPILATION_CACHE_DIR
when it is set and otherwise uses the fixed <repo>/.jax_cache."""

import os

import jax


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path):
    from hnsw_tpu.utils.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_unset_uses_fixed_repo_dir(monkeypatch):
    from hnsw_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = compile_cache.enable_compile_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        # the same path on every call: never per-process or time-stamped
        assert compile_cache.enable_compile_cache() == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
