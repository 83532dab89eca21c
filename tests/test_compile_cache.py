"""The persistent compile cache follows JAX_COMPILATION_CACHE_DIR, else
<repo>/.jax_cache."""
import os

import jax

from marginalign_trna_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_defaults_to_repo_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.compile_cache_dir() == os.path.join(
        REPO, ".jax_cache")
    assert ".jax_cache/" in open(os.path.join(REPO, ".gitignore")).read()


def test_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.configure_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
