"""JAX's persistent compilation cache, set up the same way by every entry
point (the CLI, chip_smoke.py, bench.py, tools/, the tests).

Where JAX_COMPILATION_CACHE_DIR is set, JAX already caches there and
nothing else is set.  Otherwise the cache is a fixed directory inside the
checkout (``.jax_cache/``, gitignored): the path is part of what makes a
later process find an entry, so it must not move between runs."""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE = Path(__file__).resolve().parents[1] / ".jax_cache"


def enable(subdir: str = "") -> str:
    """Turn the cache on; returns the directory in use.  `subdir` keeps a
    separate cache under the checkout directory (the CPU test suite uses
    one) and is ignored when JAX_COMPILATION_CACHE_DIR is set."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(CHECKOUT_CACHE / subdir if subdir else CHECKOUT_CACHE)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
