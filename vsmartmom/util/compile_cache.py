"""Persistent XLA compilation cache placement.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
else is set here. Otherwise the cache lives in ``.jax_cache/`` at the root
of the checkout: a fixed path, so a later run on the same checkout hits the
programs an earlier one compiled.
"""
from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
