"""JAX persistent compilation cache at a fixed place.

A compiled program is keyed by its HLO and by the cache directory, so a
directory that moves between runs never hits. The entry points (the CLI,
``bench.py``, ``chip_smoke.py``) call :func:`enable_compile_cache` once
before their first compile.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Use ``$JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache``.

    With the variable set, JAX reads it itself and nothing is configured
    here. Returns the directory in use.
    """
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
