"""Device kernels and the package's JAX settings.

The codec manipulates 64-bit windows and bit containers, so the ops package
requires x64 mode; it is enabled at import, before any tracing.

Compiled programs are kept in JAX's persistent compilation cache: where
JAX_COMPILATION_CACHE_DIR is set, JAX uses that directory; otherwise the
cache lives at `.jax_cache/` in the checkout root (a fixed path, so runs
from the same checkout hit it).
"""

import os
from pathlib import Path

import jax

CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"

jax.config.update("jax_enable_x64", True)
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
