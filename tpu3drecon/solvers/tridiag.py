"""Block-tridiagonal preconditioner: factorization + solve.

Sequential captures give the reduced camera system S a block-band
structure: S_{c,c+1} (cameras sharing tracks) dominates the off-diagonal.
A block-tridiagonal preconditioner M = tridiag(E^T, D, E) captures that
coupling exactly (the analog of Ceres' CLUSTER_TRIDIAGONAL with singleton
clusters in chain order), where the tt/wtt layouts can form E_c = S_{c,c+1}
exactly from adjacent track-slot pairs (solvers/ba_tt: track camera lists
are strictly increasing, so cam-adjacent couplings are slot-adjacent).

Factorization is a block-Cholesky Thomas sweep (lax.scan over the camera
chain — sequential steps of (np, np) block algebra); the apply is a
forward+backward substitution scan pair.  An SPD guard per step: if the
pivot D_c - W^T W loses positive definiteness (the tridiagonal PART of an
SPD matrix need not be SPD), that interface's coupling is dropped and the
step falls back to the diagonal block — the factorization then IS the
exact factorization of the modified (still SPD) preconditioner.

``segments`` splits the camera chain into independent sub-chains
(block-Jacobi of tridiagonal segments, dropping the segments-1 boundary
interfaces): the scans vmap over segments, so the sequential
depth falls from C to C/segments while the preconditioner stays exact
inside every segment.  At BAL scale (c_pad 1792) segment length 128 turns
~1.8k sequential tiny-block steps per sweep into 128.

No reference counterpart (the reference's linear solver is jaxopt's dense
Cholesky: src/reconstruction/bundle_adjustment/bundle_adjustment.py:83-91).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular


class TridiagFactor(NamedTuple):
    l_blocks: jax.Array  # (C, n, n) lower-triangular diagonal factors
    w_blocks: jax.Array  # (C, n, n) W_c = L_c^{-1} E_c (segment ends zero)
    w_used: jax.Array  # (C, n, n) W_{c-1} actually used at step c (guarded)


def auto_segments(n_blocks: int, target_len: int = 128) -> int:
    """Segment count for a C-camera chain: ~``target_len`` cameras per
    sub-chain when C divides evenly (the wtt c_pad is always a multiple of
    128), else the whole chain (short chains don't need splitting)."""
    if n_blocks >= 2 * target_len and n_blocks % target_len == 0:
        return n_blocks // target_len
    return 1


def tridiag_factor(
    d_blocks: jax.Array, e_blocks: jax.Array, segments: int = 1
) -> TridiagFactor:
    """Factor M = tridiag(E^T, D, E) as block-bidiagonal L Lt.

    ``d_blocks`` (C, n, n) SPD diagonal blocks; ``e_blocks`` (C, n, n) with
    e[c] = M[c, c+1] (the last row of each segment is dropped).  Returns
    the factor with the per-step SPD guard applied.
    """
    c, n, _ = d_blocks.shape
    assert c % segments == 0, (c, segments)
    ln = c // segments
    dtype = d_blocks.dtype
    d_seg = d_blocks.reshape(segments, ln, n, n)
    # Cross-segment interfaces are dropped (and the final row's e was
    # always ignored): zero them so w_blocks is exactly zero there.
    e_seg = e_blocks.reshape(segments, ln, n, n).at[:, -1].set(0.0)
    w0 = jnp.zeros((n, n), dtype)

    def step(w_prev, de):
        d_c, e_c = de
        d_eff = d_c - w_prev.T @ w_prev
        l_c = jnp.linalg.cholesky(d_eff)
        bad = jnp.any(jnp.isnan(l_c))
        w_prev_eff = jnp.where(bad, jnp.zeros_like(w_prev), w_prev)
        l_c = jnp.where(bad, jnp.linalg.cholesky(d_c), l_c)
        w_c = solve_triangular(l_c, e_c, lower=True)
        return w_c, (l_c, w_c, w_prev_eff)

    def chain(d_ch, e_ch):
        _, out = jax.lax.scan(step, w0, (d_ch, e_ch))
        return out

    l, w, w_used = jax.vmap(chain)(d_seg, e_seg)
    return TridiagFactor(
        l_blocks=l.reshape(c, n, n),
        w_blocks=w.reshape(c, n, n),
        w_used=w_used.reshape(c, n, n),
    )


def tridiag_solve(
    factor: TridiagFactor, r: jax.Array, segments: int = 1
) -> jax.Array:
    """Solve M z = r for the factored block tridiagonal; r is (C, n).

    ``segments`` must match the value given to ``tridiag_factor``.
    """
    c, n = r.shape
    assert c % segments == 0, (c, segments)
    ln = c // segments
    dtype = r.dtype
    l = factor.l_blocks.reshape(segments, ln, n, n)
    w = factor.w_blocks.reshape(segments, ln, n, n)
    wu = factor.w_used.reshape(segments, ln, n, n)
    rs = r.reshape(segments, ln, n)
    y0 = jnp.zeros((n,), dtype)

    def fwd(y_prev, inp):
        l_c, w_used_c, r_c = inp
        y_c = solve_triangular(l_c, r_c - w_used_c.T @ y_prev, lower=True)
        return y_c, y_c

    def bwd(z_next, inp):
        l_c, w_c, w_used_next, y_c = inp
        # Interface (c, c+1) only acts if step c+1 actually used it.
        used = jnp.any(w_used_next != 0.0)
        w_eff = jnp.where(used, w_c, jnp.zeros_like(w_c))
        z_c = solve_triangular(l_c.T, y_c - w_eff @ z_next, lower=False)
        return z_c, z_c

    def seg(l_ch, w_ch, wu_ch, r_ch):
        _, y = jax.lax.scan(fwd, y0, (l_ch, wu_ch, r_ch))
        # w_used at step c+1 tells whether the (c, c+1) interface survived
        # the guard; shift it down so step c sees its own outgoing
        # interface (segment-local: boundaries never couple).
        wu_next = jnp.concatenate([wu_ch[1:], jnp.zeros_like(wu_ch[:1])])
        _, z = jax.lax.scan(
            bwd, y0, (l_ch, w_ch, wu_next, y), reverse=True
        )
        return z

    z = jax.vmap(seg)(l, w, wu, rs)
    return z.reshape(c, n)


class SSORFactor(NamedTuple):
    d_chol: jax.Array  # (C, n, n) cholesky of the D blocks
    e_blocks: jax.Array  # (C, n, n) e[c] = S[c, c+1] (segment ends zero)


def ssor_factor(
    d_blocks: jax.Array, e_blocks: jax.Array, segments: int = 1
) -> SSORFactor:
    """Block-SSOR preconditioner M = (D+L) D^{-1} (D+L)^T, L = lower band.

    Uses the same exact D (damped schur_jacobi blocks) and E = S_{c,c+1}
    as ``tridiag_factor`` but is SPD whenever D is SPD — no guard, no
    failure mode.  Measured (experiments/precond_quality.py, 128-cam
    sequential scene): the tridiagonal PART of S is indefinite (exact
    tridiag M is WORSE than block-Jacobi: 351 vs 321 PCG iters to 1e-6),
    while SSOR cuts iterations 1.7x (192 vs 321).  This is why
    ``precond="ssor"`` exists and ``precond="tridiag"`` is not the
    default band option.
    """
    c, n, _ = d_blocks.shape
    assert c % segments == 0, (c, segments)
    ln = c // segments
    e_seg = e_blocks.reshape(segments, ln, n, n).at[:, -1].set(0.0)
    d_chol = jax.vmap(jnp.linalg.cholesky)(d_blocks)
    return SSORFactor(
        d_chol=d_chol, e_blocks=e_seg.reshape(c, n, n)
    )


def ssor_solve(
    factor: SSORFactor, r: jax.Array, segments: int = 1
) -> jax.Array:
    """Solve M z = r for block-SSOR M = (D+L) D^{-1} (D+L)^T; r is (C, n).

    Forward sweep u = (D+L)^{-1} r, then z from (D+L^T) z = D u, which
    simplifies to z_c = u_c - D_c^{-1} E_c z_{c+1} (no explicit D u).
    ``segments`` must match ``ssor_factor``; cross-segment interfaces are
    dropped (M stays SPD — it just loses those couplings).
    """
    c, n = r.shape
    assert c % segments == 0, (c, segments)
    ln = c // segments
    dtype = r.dtype
    dch = factor.d_chol.reshape(segments, ln, n, n)
    e = factor.e_blocks.reshape(segments, ln, n, n)
    rs = r.reshape(segments, ln, n)
    y0 = jnp.zeros((n,), dtype)

    def dsolve(l_c, v):
        t = solve_triangular(l_c, v, lower=True)
        return solve_triangular(l_c.T, t, lower=False)

    def fwd(u_prev, inp):
        l_c, e_prev_c, r_c = inp
        u_c = dsolve(l_c, r_c - e_prev_c.T @ u_prev)
        return u_c, u_c

    def bwd(z_next, inp):
        l_c, e_c, u_c = inp
        z_c = u_c - dsolve(l_c, e_c @ z_next)
        return z_c, z_c

    def seg(dch_ch, e_ch, r_ch):
        e_prev = jnp.concatenate([jnp.zeros_like(e_ch[:1]), e_ch[:-1]])
        _, u = jax.lax.scan(fwd, y0, (dch_ch, e_prev, r_ch))
        _, z = jax.lax.scan(bwd, y0, (dch_ch, e_ch, u), reverse=True)
        return z

    z = jax.vmap(seg)(dch, e, rs)
    return z.reshape(c, n)


def ssor_matvec(d_blocks, e_blocks, x, segments: int = 1):
    """M x for testing: applies (D+L) D^{-1} (D+L)^T blockwise."""
    c, n = x.shape
    ln = c // segments
    e = e_blocks.reshape(segments, ln, n, n).at[:, -1].set(0.0)
    e = e.reshape(c, n, n)
    # t = (D+L)^T x  ->  t_c = D_c x_c + E_c x_{c+1}
    t = jnp.einsum("cij,cj->ci", d_blocks, x)
    t = t.at[:-1].add(jnp.einsum("cij,cj->ci", e[:-1], x[1:]))
    # s = D^{-1} t
    s = jax.vmap(jnp.linalg.solve)(d_blocks, t)
    # out = (D+L) s  ->  out_c = D_c s_c + E_{c-1}^T s_{c-1}
    out = jnp.einsum("cij,cj->ci", d_blocks, s)
    out = out.at[1:].add(jnp.einsum("cji,cj->ci", e[:-1], s[:-1]))
    return out


def tridiag_matvec(d_blocks, e_blocks, x):
    """M x for testing: (C, n, n), (C, n, n), (C, n) -> (C, n)."""
    out = jnp.einsum("cij,cj->ci", d_blocks, x)
    upper = jnp.einsum("cij,cj->ci", e_blocks[:-1], x[1:])
    lower = jnp.einsum("cji,cj->ci", e_blocks[:-1], x[:-1])
    out = out.at[:-1].add(upper)
    out = out.at[1:].add(lower)
    return out
