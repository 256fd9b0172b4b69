"""Block operations for the camera/point Schur complement (matrix-free).

The normal equations of bundle adjustment have the classic arrow structure

    [ U   W ] [dc]   [ -g_c ]
    [ W^T V ] [dp] = [ -g_p ]

with U = blkdiag over cameras (8x8), V = blkdiag over points (3x3) and W the
camera-point coupling, one 8x3 block per observation.  Everything here
operates on the flat-observation layout (tpu3drecon.problems.packing): U, V,
g are built by ``jax.ops.segment_sum`` over cam_idx / pt_idx, and the reduced
camera system

    S dc = b,   S = U - W V^{-1} W^T,   b = -g_c + W V^{-1} g_p

is solved matrix-free by preconditioned CG whose matvec is two segment-sums
and two gathers — no J, JtJ, or S is ever materialized.  This is the
accelerator-resident replacement for the reference's dense-Jacobian LM wall
(SURVEY.md §7; reference capped at 15 cams / 400 pts,
benchmark_impl_bundle_adjustment.py:28-29), and the structure that shards
over the device mesh (shard the observation axis, psum the segment sums —
tpu3drecon.parallel).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from tpu3drecon.solvers.pcg import guarded_block_cholesky


def _maybe_psum(x: jax.Array, axis_name: Optional[str]) -> jax.Array:
    """psum across the observation-shard mesh axis when running inside
    shard_map (tpu3drecon.parallel); identity in single-device mode."""
    return jax.lax.psum(x, axis_name) if axis_name is not None else x


def segment_outer(a: jax.Array, b: jax.Array, idx: jax.Array, num: int) -> jax.Array:
    """sum_k a[k]^T b[k] accumulated per segment: (N,2,m),(N,2,n) -> (num,m,n)."""
    # Explicit 2-term outer product: a 2-wide einsum contraction lowers to
    # a badly padded dot_general (RESULTS.md); broadcast mul+add fuses.
    per_obs = (
        a[:, 0, :, None] * b[:, 0, None, :] + a[:, 1, :, None] * b[:, 1, None, :]
    )
    return jax.ops.segment_sum(per_obs, idx, num_segments=num)


def segment_jt_r(j: jax.Array, r: jax.Array, idx: jax.Array, num: int) -> jax.Array:
    """sum_k J[k]^T r[k] per segment: (N,2,m),(N,2) -> (num,m)."""
    per_obs = j[:, 0] * r[:, 0, None] + j[:, 1] * r[:, 1, None]
    return jax.ops.segment_sum(per_obs, idx, num_segments=num)


class NormalBlocks(NamedTuple):
    """Damped normal-equation blocks for one linearization."""

    u: jax.Array  # (C, 8, 8) damped camera blocks
    v: jax.Array  # (P, 3, 3) damped point blocks
    w: jax.Array  # (N, 8, 3) per-observation coupling blocks
    g_cam: jax.Array  # (C, 8) gradient J_c^T r
    g_pt: jax.Array  # (P, 3) gradient J_p^T r
    v_inv: jax.Array  # (P, 3, 3) inverse of damped V
    u_chol: jax.Array  # (C, 8, 8) cholesky of damped U (preconditioner)
    damp_cam: jax.Array  # (C, 8) diagonal damping actually added to U
    damp_pt: jax.Array  # (P, 3) diagonal damping actually added to V


def inv3x3(m: jax.Array) -> jax.Array:
    """Closed-form inverse of a batch of 3x3 SPD matrices (adjugate form).

    Cheaper than LU/cholesky dispatch per tiny block; damping
    guarantees well-conditioned inputs.
    """
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = c * h - b * i
    co_c = b * f - c * e
    det = a * co_a + d * co_b + g * co_c
    det_safe = jnp.where(jnp.abs(det) < 1e-32, 1.0, det)
    inv_det = 1.0 / det_safe
    adj = jnp.stack(
        [
            jnp.stack([co_a, co_b, co_c], axis=-1),
            jnp.stack([f * g - d * i, a * i - c * g, c * d - a * f], axis=-1),
            jnp.stack([d * h - e * g, b * g - a * h, a * e - b * d], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def build_normal_blocks(
    blocks_r: jax.Array,  # (N,2)
    blocks_jc: jax.Array,  # (N,2,8)
    blocks_jp: jax.Array,  # (N,2,3)
    cam_idx: jax.Array,
    pt_idx: jax.Array,
    n_cameras: int,
    n_points: int,
    lam: jax.Array,
    diag_floor: float = 1e-8,
    axis_name: Optional[str] = None,
    precond: str = "schur_jacobi",
) -> NormalBlocks:
    """Accumulate damped U, V, W, gradients from per-observation blocks.

    Marquardt damping: add lam * clamp(diag) to each block diagonal, so the
    step is scale-invariant across the wildly different parameter magnitudes
    (rotations ~1, focals ~1e3, points ~scene units).

    With precond="schur_jacobi", u_chol factors the EXACT diagonal blocks of
    S = U - W V^-1 W^T instead of U: a camera observes each point at most
    once, so S_ii = U_ii - sum_obs W_obs V^-1 W_obs^T is one obs-local
    einsum + segment-sum (psum-reducible under obs sharding) — no
    cross-camera structure needed.  SPD because S itself is SPD.
    """
    dtype = blocks_r.dtype
    u = _maybe_psum(segment_outer(blocks_jc, blocks_jc, cam_idx, n_cameras), axis_name)
    v = _maybe_psum(segment_outer(blocks_jp, blocks_jp, pt_idx, n_points), axis_name)
    w = (
        blocks_jc[:, 0, :, None] * blocks_jp[:, 0, None, :]
        + blocks_jc[:, 1, :, None] * blocks_jp[:, 1, None, :]
    )  # (N,8,3) stays obs-local
    g_cam = _maybe_psum(segment_jt_r(blocks_jc, blocks_r, cam_idx, n_cameras), axis_name)
    g_pt = _maybe_psum(segment_jt_r(blocks_jp, blocks_r, pt_idx, n_points), axis_name)

    eye8 = jnp.eye(8, dtype=dtype)
    eye3 = jnp.eye(3, dtype=dtype)
    du = jnp.clip(jnp.diagonal(u, axis1=-2, axis2=-1), diag_floor, None)
    dv = jnp.clip(jnp.diagonal(v, axis1=-2, axis2=-1), diag_floor, None)
    damp_cam = lam * du
    damp_pt = lam * dv
    u_d = u + damp_cam[..., None] * eye8
    v_d = v + damp_pt[..., None] * eye3

    v_inv = inv3x3(v_d)
    if precond == "schur_jacobi":
        vg = v_inv[pt_idx]
        wv = (
            w[..., 0, None] * vg[:, None, 0, :]
            + w[..., 1, None] * vg[:, None, 1, :]
            + w[..., 2, None] * vg[:, None, 2, :]
        )  # (N,8,3)
        g_obs = (
            wv[..., :, None, 0] * w[..., None, :, 0]
            + wv[..., :, None, 1] * w[..., None, :, 1]
            + wv[..., :, None, 2] * w[..., None, :, 2]
        )  # (N,8,8)
        coupling = _maybe_psum(
            jax.ops.segment_sum(g_obs, cam_idx, num_segments=n_cameras), axis_name
        )
        precond_mat = u_d - coupling
        u_chol = guarded_block_cholesky(precond_mat, u_d)
    else:
        precond_mat = u_d
        u_chol = jax.vmap(jnp.linalg.cholesky)(precond_mat)
    return NormalBlocks(
        u=u_d,
        v=v_d,
        w=w,
        g_cam=g_cam,
        g_pt=g_pt,
        v_inv=v_inv,
        u_chol=u_chol,
        damp_cam=damp_cam,
        damp_pt=damp_pt,
    )


def w_times(nb: NormalBlocks, y_pt: jax.Array, cam_idx: jax.Array, pt_idx: jax.Array, n_cameras: int, axis_name: Optional[str] = None) -> jax.Array:
    """(W y)_c: gather y by pt_idx, per-obs 8x3 @ 3, segment-sum by cam."""
    per_obs = jnp.sum(nb.w * y_pt[pt_idx][:, None, :], axis=-1)
    return _maybe_psum(jax.ops.segment_sum(per_obs, cam_idx, num_segments=n_cameras), axis_name)


def wt_times(nb: NormalBlocks, x_cam: jax.Array, cam_idx: jax.Array, pt_idx: jax.Array, n_points: int, axis_name: Optional[str] = None) -> jax.Array:
    """(W^T x)_p: gather x by cam_idx, per-obs 3x8 @ 8, segment-sum by point."""
    per_obs = jnp.sum(nb.w * x_cam[cam_idx][:, :, None], axis=1)
    return _maybe_psum(jax.ops.segment_sum(per_obs, pt_idx, num_segments=n_points), axis_name)


def schur_matvec(
    nb: NormalBlocks, x_cam: jax.Array, cam_idx: jax.Array, pt_idx: jax.Array,
    axis_name: Optional[str] = None,
) -> jax.Array:
    """S x = U x - W V^{-1} W^T x, matrix-free.

    Sharded mode: U x is replicated math; the two W applications reduce
    obs-local contributions with one psum each per CG iteration.
    """
    n_cameras = nb.u.shape[0]
    n_points = nb.v.shape[0]
    ux = jnp.sum(nb.u * x_cam[:, None, :], axis=-1)
    wtx = wt_times(nb, x_cam, cam_idx, pt_idx, n_points, axis_name)
    vinv_wtx = jnp.sum(nb.v_inv * wtx[:, None, :], axis=-1)
    return ux - w_times(nb, vinv_wtx, cam_idx, pt_idx, n_cameras, axis_name)


def precond_apply(nb: NormalBlocks, r_cam: jax.Array) -> jax.Array:
    """Block-Jacobi preconditioner: per-camera solve with chol(U_damped)."""
    return jax.vmap(
        lambda ch, rr: jax.scipy.linalg.cho_solve((ch, True), rr)
    )(nb.u_chol, r_cam)


class PCGResult(NamedTuple):
    x: jax.Array  # (C, 8)
    iters: jax.Array
    rel_residual: jax.Array


def schur_pcg(
    nb: NormalBlocks,
    b_cam: jax.Array,  # (C, 8)
    cam_idx: jax.Array,
    pt_idx: jax.Array,
    maxiter: int = 100,
    rtol: float = 1e-6,
    axis_name: Optional[str] = None,
) -> PCGResult:
    """Preconditioned CG on the reduced camera system S x = b.

    Entirely lax-level, so the whole LM outer loop stays one XLA executable
    (shared core: solvers/pcg.py).
    """
    from tpu3drecon.solvers.pcg import pcg

    out = pcg(
        lambda p: schur_matvec(nb, p, cam_idx, pt_idx, axis_name),
        lambda r: precond_apply(nb, r),
        b_cam, maxiter, rtol,
    )
    rel = jnp.sqrt(jnp.sum(out.r * out.r) / out.b_norm2)
    return PCGResult(x=out.x, iters=out.iters, rel_residual=rel)


def back_substitute_points(
    nb: NormalBlocks,
    dc: jax.Array,  # (C, 8) camera step
    cam_idx: jax.Array,
    pt_idx: jax.Array,
    axis_name: Optional[str] = None,
) -> jax.Array:
    """dp = V^{-1} (-g_p - W^T dc)."""
    n_points = nb.v.shape[0]
    wt_dc = wt_times(nb, dc, cam_idx, pt_idx, n_points, axis_name)
    return jnp.sum(nb.v_inv * (-nb.g_pt - wt_dc)[:, None, :], axis=-1)
