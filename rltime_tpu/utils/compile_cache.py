"""Where JAX's persistent compilation cache lives: one rule for every
entry point (train, train_distributed, eval, bench, chip_smoke, tools).

`JAX_COMPILATION_CACHE_DIR`, when set, is the cache and JAX reads it on
its own; nothing is set in code. Otherwise the cache is the fixed
directory `.jax_cache/` at the checkout root (git ignores it). A fixed
path matters: the cache is keyed by where it lives, so a directory
that moved between runs would never hit.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the cache uses under the rule above."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Apply the rule; call before the first compilation. Returns the
    cache directory."""
    if not os.environ.get(ENV_VAR):
        import jax
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return cache_dir()
