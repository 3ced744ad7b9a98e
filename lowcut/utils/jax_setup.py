"""One-time JAX configuration for the framework.

Points JAX's persistent compilation cache at a fixed directory, so a
program compiled once (the double-float FFT graphs take long to compile)
is reused by every later process. Where ``JAX_COMPILATION_CACHE_DIR`` is
set, JAX uses that directory and nothing here overrides it; otherwise the
cache lives in ``.jax_cache/`` at the checkout root. Idempotent and safe to
call from multiple entry points.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_ROOT = Path(__file__).resolve().parents[2]

_configured = False


def compilation_cache_dir() -> str | None:
    """The cache directory this package sets, or None when
    ``JAX_COMPILATION_CACHE_DIR`` already names one."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(CHECKOUT_ROOT / ".jax_cache")


def configure_jax() -> None:
    global _configured
    if _configured:
        return
    _configured = True
    cache_dir = compilation_cache_dir()
    if cache_dir is None:
        return
    import jax

    try:
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    except OSError:
        pass  # cache is an optimization; never fail the pipeline for it
