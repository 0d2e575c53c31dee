"""Persistent XLA compilation cache location.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this
module sets nothing. Otherwise the cache lives at a fixed path inside
the checkout (listed in .gitignore): the path is part of the cache
key, so a directory that moves between runs never hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def configure() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
