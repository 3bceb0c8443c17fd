"""Where the scripts at the checkout root keep JAX's persistent compile cache.

``bench.py`` and ``chip_smoke.py`` compile large programs (the cycle, the
PCG loop) whose compile time is a real share of a cold run.  The cache path
is part of the cache's key, so it is fixed: ``JAX_COMPILATION_CACHE_DIR``
when set (JAX reads it itself and nothing else is changed), otherwise
``.jax_cache/`` at the checkout root.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["enable_compile_cache"]

ENV = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache(root) -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory.  ``root`` is the checkout root."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax

    path = str(Path(root).resolve() / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
