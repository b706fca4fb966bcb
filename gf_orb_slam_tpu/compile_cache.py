"""Where the entry points keep JAX's persistent compilation cache.

The cache's directory is part of what makes an entry hit, so it must not
move between runs: a path built from a temp name, a PID or the time never
hits again.
"""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing is
    changed. Otherwise the cache goes to the fixed in-checkout
    DEFAULT_CACHE_DIR (listed in .gitignore). Call before the first compile.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
