"""Disk cache for expensive host-side problem builds.

BAL-scale packing (synthetic scene generation + flat packing +
``wtt_from_flat``) is minutes of host-side numpy/jax-CPU work per
process — paid again by every experiment/benchmark process even when the
XLA compile itself is served by jax's persistent compilation cache
(utils/compile_cache.py).  This module memoizes the *built problem
pytree* on disk, with every array leaf converted to numpy so that

- no device buffers are pickled (jax arrays don't round-trip), and
- a cache hit needs no jax at all; ``utils/placement.commit`` later
  places numpy leaves on the target device.

Reference anchor: the reference rebuilds datasets from disk per run
(src/dataset/loaders/colmap_dataset_loader/loader.py),
caching nothing; this is a capability it lacks.

Usage::

    wtt = cached_problem("balseq_1712x584_s7n0.5_pc512_v1", build_fn)

Keys are caller-chosen strings; bump the version suffix when the builder
semantics change.  Set TPU3DRECON_PROBLEM_CACHE_DIR to relocate,
TPU3DRECON_PROBLEM_CACHE_DISABLE=1 to bypass.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Optional

_DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".problem_cache"


def _cache_dir(cache_dir=None) -> Path:
    return Path(
        cache_dir
        or os.environ.get("TPU3DRECON_PROBLEM_CACHE_DIR")
        or _DEFAULT_DIR
    )


def _disabled() -> bool:
    return os.environ.get("TPU3DRECON_PROBLEM_CACHE_DISABLE", "") not in ("", "0")


def _to_numpy(tree: Any) -> Any:
    """Convert every array leaf to numpy; leave scalars/static leaves alone."""
    import jax
    import numpy as np

    def conv(x):
        if isinstance(x, jax.Array):
            return np.asarray(jax.device_get(x))
        return x

    return jax.tree_util.tree_map(conv, tree)


def cached_problem(
    key: str,
    builder: Callable[[], Any],
    cache_dir=None,
    verbose: Optional[bool] = None,
) -> Any:
    """Return ``builder()``, memoized on disk under ``key``.

    The stored value is the builder's pytree with numpy leaves (see
    module docstring).  Cache misses write atomically (tmp + rename) so
    concurrent processes can share a cache directory.
    """
    if verbose is None:
        verbose = os.environ.get("TPU3DRECON_PROBLEM_CACHE_VERBOSE", "") not in ("", "0")
    if _disabled():
        return builder()
    d = _cache_dir(cache_dir)
    h = hashlib.sha256(key.encode()).hexdigest()[:32]
    path = d / f"{h}.pkl"
    if path.exists():
        t0 = time.time()
        try:
            with open(path, "rb") as f:
                obj = pickle.load(f)
        except Exception as e:
            # Stale entry (e.g. a cached dataclass gained a field) or a
            # truncated write: drop it and rebuild instead of crashing
            # every consumer of this key until someone deletes the file.
            if verbose:
                print(f"problem_cache: stale entry {path.name}: {e!r}",
                      flush=True)
            try:
                path.unlink()
            except OSError:
                pass
        else:
            if verbose:
                print(
                    f"problem_cache: HIT {path.name} ({key}) "
                    f"load {time.time()-t0:.1f}s",
                    flush=True,
                )
            return obj
    obj = _to_numpy(builder())
    d.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if verbose:
        print(
            f"problem_cache: MISS -> wrote {path.name} "
            f"({path.stat().st_size/1e6:.0f} MB) for {key}",
            flush=True,
        )
    return obj


def clear(cache_dir=None) -> int:
    d = _cache_dir(cache_dir)
    n = 0
    if d.exists():
        for p in d.glob("*.pkl"):
            p.unlink()
            n += 1
    return n
