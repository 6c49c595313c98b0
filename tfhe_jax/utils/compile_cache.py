"""Persistent XLA compilation cache for the entry points.

The blind-rotation gate compiles in seconds to minutes; keeping compiled
programs on disk makes every later process that runs the same shapes start
warm.  JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is unset the
cache lives at one fixed, git-ignored path inside the checkout (a fixed path,
because the cache key depends on it).
"""

from __future__ import annotations

import os

import jax

#: cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is not set
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
