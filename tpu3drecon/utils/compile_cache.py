"""Persistent XLA compilation cache, placed from outside.

jax's persistent compilation cache turns a fresh process's compile of the
solve into a disk read for every process after the first.  Call
``enable_compilation_cache()`` BEFORE the first jit execution (it only sets
config, so any time before the first compile works).

Where the cache lives is the deployment's choice: ``JAX_COMPILATION_CACHE_DIR``
names it, and then this module sets nothing else.  Unset, the cache goes to
the fixed ``<checkout>/.jax_cache`` (gitignored): the path is part of the
cache key, so a directory that moves between runs never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"
_ENV = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> Path:
    """The directory the cache uses: ``$JAX_COMPILATION_CACHE_DIR`` or the
    fixed default."""
    return Path(os.environ.get(_ENV) or DEFAULT_DIR)


def enable_compilation_cache() -> str:
    """Enable jax's persistent compilation cache; returns the cache dir.

    With ``JAX_COMPILATION_CACHE_DIR`` set, jax reads that variable itself
    and this function changes no setting.  ``TPU3DRECON_CACHE_DISABLE=1``
    makes this a no-op: the test suite sets it because jax's cache WRITE
    path has segfaulted suite runs under concurrent load, and the cache
    buys nothing on the fast-compiling virtual CPU mesh.
    """
    import jax

    if os.environ.get("TPU3DRECON_CACHE_DISABLE"):
        return ""
    if os.environ.get(_ENV):
        return os.environ[_ENV]
    DEFAULT_DIR.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)


def cache_entry_count() -> int:
    """Number of cached executables currently on disk (0 if no cache yet)."""
    path = cache_dir()
    if not path.is_dir():
        return 0
    return sum(1 for p in path.iterdir() if p.is_file())
