"""Persistent XLA compilation cache.

Cold-compiling the solver graphs costs seconds per shape; JAX's persistent
compilation cache lets every process after the first reuse the compiled executables
(shape bucketing in the estimator keeps the set of distinct graphs small).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this module sets
no other directory. Otherwise the cache lives at a fixed path inside the checkout,
``<repo>/.jax_cache`` (git-ignored): the path is part of the cache key, so it is never
built from a temporary name, a process id or the time.
"""

import os

import jax

CACHE_ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str:
    """Enable the on-disk XLA compilation cache; returns the cache directory."""
    cache_dir = os.environ.get(CACHE_ENV_VAR)
    if not cache_dir:
        cache_dir = DEFAULT_CACHE_DIR
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir
