"""Persistent XLA compile cache placement.

Compiling the 1080p programs takes a large share of a cold run, so the
entry points (CLI, bench.py, chip_smoke.py) keep compiled programs on
disk.  ``JAX_COMPILATION_CACHE_DIR`` wins when it is set: JAX reads it
itself and nothing is set here.  Otherwise the cache sits at one fixed
path inside the checkout (listed in .gitignore): the path is part of
the cache key, so a temp-, pid- or time-derived path would never hit.
"""
from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"
ENV = "JAX_COMPILATION_CACHE_DIR"


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
