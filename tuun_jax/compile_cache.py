"""Persistent XLA compilation cache.

Entry points (CLI, REPL, bench) opt in, so a repeated session reuses the
executables an earlier one compiled.  Where JAX_COMPILATION_CACHE_DIR is
set, JAX keeps its cache there and this module sets nothing; otherwise the
cache lives at a fixed path inside the checkout, `<checkout>/.jax_cache`
(the path is part of the cache key: a directory that moves never hits).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

DEFAULT_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable() -> Optional[str]:
    """Points JAX at the on-disk compilation cache; call before the first
    compile.  Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    # Everything nontrivial: even 1-second compiles repeat across
    # sessions (the REPL recompiles per voice structure).
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return str(DEFAULT_DIR)
