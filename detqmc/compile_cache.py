"""Persistent XLA compilation cache setup.

Sweep programs take tens of seconds to compile; the persistent cache lets
every later process (simulation runs, bench.py, chip_smoke.py, tests) reuse a
program compiled once per (HLO, flags).

Rules: when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
nothing is set here. Otherwise the cache lives at a fixed path inside the
checkout, ``<repo>/.jax_cache`` (listed in .gitignore): the path is part
of the cache key, so a directory that moved between runs would never hit.
"""

from __future__ import annotations

import os

import jax

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def enable() -> None:
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    if jax.config.jax_compilation_cache_dir:
        return
    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
