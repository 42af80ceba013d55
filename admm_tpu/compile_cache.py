"""Persistent XLA compilation cache for the repository's entry scripts.

Called by ``chip_smoke.py``, ``bench.py`` and
``benchmarks/run_baselines.py`` before their first compile; never at
package import, so a library user's own JAX settings are untouched.
"""
from __future__ import annotations

import os
from pathlib import Path

# Fixed, git-ignored path inside the checkout: the cache key includes the
# directory, so a temp- or time-based path would never hit.
DEFAULT_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at one directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself
    and nothing else is set.  Otherwise the cache lives in
    :data:`DEFAULT_DIR`.  Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
