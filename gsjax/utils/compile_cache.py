"""Persistent XLA compilation cache.

`enable()` keeps compiled programs across processes: in the directory
that `JAX_COMPILATION_CACHE_DIR` names when it is set, else in a fixed
directory inside the checkout (`.jax_cache/`, git-ignored). The path is
part of the cache key, so it must not move between runs. Call it before
the first jit.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable(min_compile_secs: float = 1.0) -> str:
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_secs
    )
    return path
