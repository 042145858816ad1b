"""JAX's persistent compilation cache at one fixed place.

A cold run compiles every chain it touches; the persistent cache lets
the next process on the same checkout load those executables instead.
JAX keys the cache on its directory, so the directory must not move
between runs: it is never made from a temporary name, a pid or the time.
"""

from __future__ import annotations

import os
import pathlib

# <checkout>/.jax_cache (listed in .gitignore)
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its fixed directory and
    return the directory in use.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself,
    so nothing is set here.  Otherwise the cache lives in
    ``<checkout>/.jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
