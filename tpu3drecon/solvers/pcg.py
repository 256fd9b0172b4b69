"""Shared preconditioned-CG core for every BA engine.

All five engines (flat/grid/pallas/tt/wtt) solve the same reduced camera
system S x = b with PCG and differ ONLY in how the Schur matvec and the
block preconditioner are evaluated on their layout.  One implementation
here — tolerances, breakdown guards, and iteration accounting stay
engine-uniform, which is what keeps the engines step-equivalent
(tests/test_ba_*.py assert identical trust-region trajectories).

Sharding note: callers run this inside shard_map with replicated CG state;
the matvec callable owns the single psum that re-replicates its result, so
every dot product here is local (see solvers/ba_tt._pcg docstring history).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class PCGOut(NamedTuple):
    x: jax.Array
    iters: jax.Array
    r: jax.Array  # final residual (callers derive rel_residual if needed)
    b_norm2: jax.Array


def pcg(
    matvec: Callable[[jax.Array], jax.Array],
    precond: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    maxiter,
    rtol,
) -> PCGOut:
    """PCG with absolute-breakdown guards; stops at ||r||^2 <= rtol^2 ||b||^2.

    ``maxiter``/``rtol`` may be Python numbers or jnp scalars (the dynamic
    hyperparameter path passes runtime operands — one compile per static
    config, see solvers.bundle_adjust.DynamicBAParams).
    """
    dtype = b.dtype

    def dot(a, b_):
        return jnp.sum(a * b_)

    z0 = precond(b)
    rz0 = dot(b, z0)
    b_norm2 = jnp.maximum(dot(b, b), jnp.asarray(1e-32, dtype))
    tol2 = jnp.asarray(rtol, dtype) ** 2 * b_norm2

    def cond(st):
        _, r, _, _, _, i, _ = st
        return jnp.logical_and(i < maxiter, dot(r, r) > tol2)

    def body(st):
        x, r, z, p, rz, i, x_good = st
        sp = matvec(p)
        psp = dot(p, sp)
        alpha = rz / jnp.where(jnp.abs(psp) < 1e-32, 1.0, psp)
        x = x + alpha * p
        r = r - alpha * sp
        z = precond(r)
        rz_new = dot(r, z)
        beta = rz_new / jnp.where(jnp.abs(rz) < 1e-32, 1.0, rz)
        # Breakdown guard: a NaN/inf iterate (overflowing matvec, NaN
        # preconditioner) makes ``dot(r, r) > tol2`` false, so the loop
        # exits — but the junk x would poison the LM candidate.  Track the
        # last finite iterate and return that instead; on healthy solves
        # the select is identity (bit-identical results).
        ok = jnp.isfinite(dot(x, x) + dot(r, r))
        x_good = jnp.where(ok, x, x_good)
        return (x, r, z, z + beta * p, rz_new, i + 1, x_good)

    zero = jnp.zeros_like(b)
    x, r, _, _, _, iters, x_good = jax.lax.while_loop(
        cond, body, (zero, b, z0, z0, rz0, jnp.zeros((), jnp.int32), zero)
    )
    return PCGOut(x=x_good, iters=iters, r=r, b_norm2=b_norm2)


def guarded_block_cholesky(precond_mat: jax.Array, u_d: jax.Array) -> jax.Array:
    """Per-camera cholesky of the preconditioner blocks with an SPD fallback.

    The Schur-Jacobi preconditioner ``u_d - W V^-1 W^T`` is only SPD when
    the dropped off-diagonal coupling is small.  At small LM damping a
    block can go indefinite; its cholesky returns NaN, which poisons PCG
    from ``z0`` — the residual test is false for NaN, so CG exits after
    one iteration with a junk step the trust region must reject.  Measured
    at BAL scale as cg_iters collapsing to 1 and two rejected LM
    iterations after every accepted one (lam ~3e-5, RESULTS.md).  Blocks whose Schur cholesky fails fall back to the
    cholesky of the damped U block — SPD by construction (PSD
    Gauss-Newton sum plus positive diagonal damping), i.e. plain
    block-Jacobi for exactly the unsound cameras, bit-identical factors
    everywhere else.
    """
    chol = jax.vmap(jnp.linalg.cholesky)(precond_mat)
    bad = jnp.isnan(chol).any(axis=(-2, -1))
    fallback = jax.vmap(jnp.linalg.cholesky)(u_d)
    return jnp.where(bad[:, None, None], fallback, chol)


def cho_block_precond(u_chol: jax.Array) -> Callable[[jax.Array], jax.Array]:
    """Block preconditioner from per-camera cholesky factors (C, np, np)."""

    def apply(r):
        return jax.vmap(
            lambda ch, rr: jax.scipy.linalg.cho_solve((ch, True), rr)
        )(u_chol, r)

    return apply
