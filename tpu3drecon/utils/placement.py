"""Placing host-built problems on the device.

Host-side packers build their arrays under ``jax.default_device(cpu)`` (or
as numpy).  These helpers move such a pytree onto the target device or
sharding in one explicit step, so a solver never receives arrays that still
live on another platform, and each leaf is copied once: a jax leaf that is
on another platform goes through numpy first, one already on the target
is left alone.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import numpy as np


def sharded_put(x: Any, sharding: Any) -> Any:
    """``jax.device_put`` onto a (Named)Sharding, taking leaves that live
    on another platform through numpy first (see module docstring)."""
    if isinstance(x, jax.Array):
        src = {d.platform for d in getattr(x.sharding, "device_set", set())}
        tgt = {d.platform for d in sharding.device_set}
        if src and src != tgt:
            x = np.asarray(jax.device_get(x))
    return jax.device_put(x, sharding)


def commit(tree: Any, device: Optional[Any] = None) -> Any:
    """Place a pytree on ``device`` (default: the default jax device);
    leaves already there are returned as they are."""
    tgt = device if device is not None else jax.devices()[0]

    def put(x):
        if isinstance(x, jax.Array):
            devs = getattr(x.sharding, "device_set", None)
            if devs == {tgt}:
                return x
            x = np.asarray(jax.device_get(x))
        return jax.device_put(x, tgt)

    return jax.tree_util.tree_map(put, tree)
