"""Where JAX keeps its persistent compilation cache.

JAX_COMPILATION_CACHE_DIR, when set, is the cache and nothing here
overrides it.  Otherwise the cache is <repo>/.jax_cache (listed in
.gitignore): a fixed path, because the path is part of the cache key.
"""
from __future__ import annotations

import os

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compile_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE


def configure_compile_cache() -> str:
    """Point JAX's persistent cache at compile_cache_dir(); returns it."""
    import jax

    cache = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", cache)
    return cache
