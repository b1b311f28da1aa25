"""Where the entry points keep JAX's persistent compilation cache.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set, the
cache stays there and nothing here overrides it. Otherwise the entry
points (``chip_smoke.py``, ``bench.py``, the CLI, the performance
tester) keep it in one fixed, git-ignored directory of the checkout,
:data:`CACHE_DIR`: a fixed path lets a later process find what an
earlier one compiled.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    '.jax_cache')


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    import jax

    env = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if env:
        return env
    jax.config.update('jax_compilation_cache_dir', CACHE_DIR)
    return CACHE_DIR
