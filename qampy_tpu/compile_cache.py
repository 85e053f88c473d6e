"""Persistent compilation cache for the entry scripts.

``enable()`` is called by bench.py, chip_smoke.py and profiling.py before
their first compilation. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
reads it itself and nothing is set here. Otherwise the cache lives at a
fixed path inside the checkout (``<repo>/.jax_cache``, listed in
.gitignore): the path is part of the cache key, so a moving directory would
never hit.
"""
from __future__ import annotations

import os

#: default cache directory: the checkout root's .jax_cache
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable():
    """Turn the persistent compilation cache on; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
