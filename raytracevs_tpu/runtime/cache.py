"""Persistent compilation cache setup (the shader cache analog).

The reference caches compiled shader bytecode keyed by driver version,
adapter LUID and source SHA-256 (ShaderCache.h:33-47); for jit programs the
equivalent is JAX's persistent compilation cache — keyed by backend,
program fingerprint and jaxlib version, so a process restart skips the
XLA compiles of the render pipeline.
"""
from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def resolve_cache_dir() -> str:
    """`JAX_COMPILATION_CACHE_DIR` when set (JAX reads it itself), else
    `<repo>/.jax_cache`: a fixed path inside the checkout, because the path
    is part of the cache key."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable_compilation_cache(min_compile_time: float = 1.0) -> str:
    """Turn on the persistent compilation cache; returns its directory.

    Idempotent; call before the first jit execution. Sets no directory of
    its own when `JAX_COMPILATION_CACHE_DIR` is set. The whole cache stays
    off while `jax_enable_compilation_cache` is False (the tests set it).
    """
    import jax

    directory = resolve_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(directory, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", directory)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_time)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return directory
