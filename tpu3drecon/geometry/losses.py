"""Robust loss functions for reprojection residuals.

Covers both loss families of the reference:
  - JAX losses l2/cauchy applied *inside* the residual vector
    (reference: src/reconstruction/bundle_adjustment/loss.py:7-19), and
  - CPU evaluation losses cauchy/trivial applied to squared errors
    (reference: src/dataset/loss_functions.py:7-17).

For the LM engines the recommended use is IRLS-style robust *whitening*:
residuals are scaled by sqrt(rho'(s)) with s = ||r||^2, which preserves the
Gauss-Newton structure (J stays 2-row per observation) while matching the
robust objective to first order — the same scheme Ceres uses for its robust
kernels.
"""

from __future__ import annotations

import enum
from typing import Callable

import jax
import jax.numpy as jnp


def l2_loss(y: jax.Array, x: jax.Array) -> jax.Array:
    """Per-coordinate squared error (reference loss.py:7-9)."""
    return (y - x) ** 2


def cauchy_loss(y: jax.Array, x: jax.Array, scale: float = 1.0) -> jax.Array:
    """Per-coordinate log(1 + e^2) error (reference loss.py:12-14)."""
    return jnp.log1p(l2_loss(y, x) ** scale)


def trivial_rho(s: jax.Array) -> jax.Array:
    """rho(s) = s (no robustification)."""
    return s


def cauchy_rho(s: jax.Array) -> jax.Array:
    """rho(s) = log(1 + s) — Cauchy robust kernel on squared error s."""
    return jnp.log1p(s)


def huber_rho(s: jax.Array, delta: float = 1.0) -> jax.Array:
    """Huber kernel on squared error s (delta in residual units)."""
    d2 = delta * delta
    return jnp.where(s <= d2, s, 2.0 * delta * jnp.sqrt(jnp.maximum(s, d2)) - d2)


def robust_weight(rho: "RobustLoss", s: jax.Array) -> jax.Array:
    """IRLS weight w = rho'(s) for squared-error input s (>= 0)."""
    if rho == RobustLoss.TRIVIAL:
        return jnp.ones_like(s)
    if rho == RobustLoss.CAUCHY:
        return 1.0 / (1.0 + s)
    if rho == RobustLoss.HUBER:
        delta = 1.0
        return jnp.where(s <= delta * delta, jnp.ones_like(s), delta / jnp.sqrt(jnp.maximum(s, delta * delta)))
    raise ValueError(f"unknown robust loss {rho}")


class RobustLoss(enum.Enum):
    """Robust kernels for the LM engine (counterpart of JaxLossFunction,
    reference loss.py:17-19, and LossFunction, loss_functions.py:14-17)."""

    TRIVIAL = "trivial"
    CAUCHY = "cauchy"
    HUBER = "huber"

    @property
    def rho(self) -> Callable[[jax.Array], jax.Array]:
        return {
            RobustLoss.TRIVIAL: trivial_rho,
            RobustLoss.CAUCHY: cauchy_rho,
            RobustLoss.HUBER: huber_rho,
        }[self]
