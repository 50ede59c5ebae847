"""JAX's persistent compilation cache, in one place.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this
module sets no other directory. Otherwise the cache lives at a fixed path,
`<checkout>/.jax_cache`: the path is part of every cache key, so a
directory that moved between runs would never hit.
"""

from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; return its directory."""
    env = os.environ.get(ENV)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
