"""Where JAX keeps its persistent compile cache for this program.

``JAX_COMPILATION_CACHE_DIR``, when set, is used as JAX reads it and no
other cache is set here.  Otherwise the cache goes to one fixed directory
inside the checkout (``.jax_cache``, git-ignored): the path is part of
the cache key, so a fixed path is what lets a later run hit it.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
