"""Grid-layout bundle adjustment: the scatter-free single-chip fast path.

Same LM/implicit-Schur algorithm as tpu3drecon.solvers.bundle_adjust (same
damping control, same convergence semantics — equality is asserted in
tests/test_ba_grid.py), but every reduction is restructured scatter-free
using the (C, K) observation grid + (P, T) track table of
tpu3drecon.problems.grid:

  - per-observation blocks are computed as scalar *planes* over (C, K) —
    no per-observation tiny-matrix tensors with 2/3-wide trailing dims;
  - U, g_c and the camera half of every W matvec contract over the K axis
    as batched matmuls;
  - V, g_p and the point half of W^T matvecs gather via the track table and
    reduce densely over T — zero scatters anywhere in the solve.

The flat-layout engine remains the multi-chip path (its segment-sums psum
cleanly over an observation-sharded mesh); this one trades the flat
engine's scatter-adds for gathers and batched matmuls.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from tpu3drecon.geometry.losses import RobustLoss, robust_weight
from tpu3drecon.ops.jacobians import apply_se3_retraction
from tpu3drecon.problems.grid import BAGridProblem
from tpu3drecon.problems.packing import CameraParams
from tpu3drecon.solvers.bundle_adjust import BAConfig, BAState
from tpu3drecon.solvers.pcg import guarded_block_cholesky, pcg
from tpu3drecon.solvers.schur import inv3x3


class GridBlocks(NamedTuple):
    r: jax.Array  # (C, K, 2) whitened residual planes
    jc: jax.Array  # (C, K, 2, 8)
    jp: jax.Array  # (C, K, 2, 3)


def grid_blocks(
    rmats: jax.Array,
    tvecs: jax.Array,
    fx_fy: jax.Array,
    cx_cy_skew: jax.Array,
    dist: jax.Array,
    points3d: jax.Array,
    problem: BAGridProblem,
    loss: RobustLoss,
) -> GridBlocks:
    """Residual + Jacobian planes over the (C, K) grid (scalar-plane math;
    same formulas as ops/jacobians.obs_blocks — incl. the radial-distortion
    chain factor A = s I + g m m^T — verified equal in tests)."""
    dtype = points3d.dtype
    x_w = points3d[problem.pt_idx]  # (C, K, 3) gather
    # Explicit 3-term rotation apply: a 3-wide einsum contraction lowers to
    # a dot_general that matrix units pad badly (RESULTS.md); mul+add
    # chains fuse into one elementwise pass.
    xc = (
        rmats[:, None, :, 0] * x_w[..., 0:1]
        + rmats[:, None, :, 1] * x_w[..., 1:2]
        + rmats[:, None, :, 2] * x_w[..., 2:3]
    ) + tvecs[:, None, :]
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-12, jnp.asarray(1.0, dtype), z)
    iz = 1.0 / z_safe
    fx = fx_fy[:, 0:1]
    fy = fx_fy[:, 1:2]
    cx = cx_cy_skew[:, 0:1]
    cy = cx_cy_skew[:, 1:2]
    sk = cx_cy_skew[:, 2:3]
    k1 = dist[:, 0:1]
    k2 = dist[:, 1:2]

    mx = x * iz
    my = y * iz
    r2 = mx * mx + my * my
    s_rad = 1.0 + k1 * r2 + k2 * r2 * r2
    g_rad = 2.0 * k1 + 4.0 * k2 * r2
    mdx = s_rad * mx
    mdy = s_rad * my

    u = fx * mdx + sk * mdy + cx
    v = fy * mdy + cy
    r = jnp.stack([u, v], axis=-1) - problem.uv
    s = jnp.sum(r * r, axis=-1)
    w = robust_weight(loss, jax.lax.stop_gradient(s))
    scale = jnp.sqrt(w) * problem.mask * (1.0 / problem.avg_cam_width)

    # dm'/dX_c = A @ dm/dX_c as planes (A = s I + g m m^T).
    axx = s_rad + g_rad * mx * mx
    axy = g_rad * mx * my
    ayy = s_rad + g_rad * my * my
    b00 = axx * iz
    b01 = axy * iz
    b02 = -(axx * mx + axy * my) * iz
    b10 = axy * iz
    b11 = ayy * iz
    b12 = -(axy * mx + ayy * my) * iz

    # dpi/dX_c = K2 @ dm'/dX_c entries as planes.
    a11 = fx * b00 + sk * b10
    a12 = fx * b01 + sk * b11
    a13 = fx * b02 + sk * b12
    a21 = fy * b10
    a22 = fy * b11
    a23 = fy * b12

    # J_rot = dpi @ (-[X_c]_x)  (expanded by hand).
    jr00 = -a12 * z + a13 * y
    jr01 = a11 * z - a13 * x
    jr02 = -a11 * y + a12 * x
    jr10 = -a22 * z + a23 * y
    jr11 = a21 * z - a23 * x
    jr12 = -a21 * y + a22 * x

    # J_f: du/dfx = m'_x, dv/dfy = m'_y.
    jf00 = mdx
    jf11 = mdy
    zero = jnp.zeros_like(a11)

    # Row-major camera block planes: (C, K, 2, 8).
    jc = jnp.stack(
        [
            jnp.stack([jr00, jr01, jr02, a11, a12, a13, jf00, zero], axis=-1),
            jnp.stack([jr10, jr11, jr12, a21, a22, a23, zero, jf11], axis=-1),
        ],
        axis=-2,
    )

    # J_pt = dpi @ R: contract dpi rows with the camera rotation.
    dpi = jnp.stack(
        [
            jnp.stack([a11, a12, a13], axis=-1),
            jnp.stack([a21, a22, a23], axis=-1),
        ],
        axis=-2,
    )  # (C, K, 2, 3)
    # jp[..., r, j] = sum_i dpi[..., r, i] * rmats[:, i, j] (3 terms).
    jp = (
        dpi[..., 0:1] * rmats[:, None, None, 0, :]
        + dpi[..., 1:2] * rmats[:, None, None, 1, :]
        + dpi[..., 2:3] * rmats[:, None, None, 2, :]
    )

    sc = scale[..., None]
    return GridBlocks(r=r * sc, jc=jc * sc[..., None], jp=jp * sc[..., None])


class GridNormal(NamedTuple):
    u: jax.Array  # (C, 8, 8) damped
    v_inv: jax.Array  # (P, 3, 3)
    u_chol: jax.Array  # (C, 8, 8)
    g_cam: jax.Array  # (C, 8)
    g_pt: jax.Array  # (P, 3)
    damp_cam: jax.Array  # (C, 8)
    damp_pt: jax.Array  # (P, 3)
    jc: jax.Array  # (C, K, 2, 8) kept for matvecs
    jp: jax.Array  # (C, K, 2, 3)
    jp_g: jax.Array  # (P, T, 2, 3) track-gathered jp
    jc_g: jax.Array  # (P, T, 2, 8) track-gathered jc


def build_grid_normal(
    blocks: GridBlocks, problem: BAGridProblem, lam: jax.Array,
    diag_floor: float = 1e-8, precond: str = "schur_jacobi",
) -> GridNormal:
    C, K = problem.uv.shape[:2]
    P, T = problem.track_idx.shape
    dtype = blocks.r.dtype

    jc2 = blocks.jc.reshape(C, K * 2, 8)
    r2 = blocks.r.reshape(C, K * 2)
    u = jnp.einsum("cni,cnj->cij", jc2, jc2)  # batched matmul
    g_cam = jnp.einsum("cni,cn->ci", jc2, r2)

    # One fused track gather: pack [Jp | r] per (obs, row) so each gathered
    # row is 4 wide (fusing halves the gather count), then one more for Jc
    # (8 wide).
    packed = jnp.concatenate(
        [blocks.jp, blocks.r[..., None]], axis=-1
    ).reshape(C * K, 2, 4)
    tm = problem.track_mask[..., None, None]
    packed_g = packed[problem.track_idx] * tm  # (P, T, 2, 4)
    jp_g = packed_g[..., :3]
    r_g = packed_g[..., 3]
    jc_g = blocks.jc.reshape(C * K, 2, 8)[problem.track_idx] * tm
    jp_g2 = jp_g.reshape(P, T * 2, 3)
    # Tiny 3x3 outputs: broadcast-product + reduce, not batched micro-dots.
    v = jnp.sum(jp_g2[..., :, None] * jp_g2[..., None, :], axis=1)
    g_pt = jnp.sum(jp_g2 * r_g.reshape(P, T * 2)[..., None], axis=1)

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
        # Exact S diagonal blocks (see schur.build_normal_blocks): per-cell
        # W = jc^T jp, then W vinv W^T reduced over the K axis — the vinv
        # gather by pt_idx happens once per linearization, not per matvec.
        # W = jc^T jp per cell (2-term over the residual rows).
        w_cell = (
            blocks.jc[..., 0, :, None] * blocks.jp[..., 0, None, :]
            + blocks.jc[..., 1, :, None] * blocks.jp[..., 1, None, :]
        )  # (C,K,8,3)
        vinv_g = v_inv[problem.pt_idx]  # (C,K,3,3)
        # wv[i, l] = sum_j w[i, j] * vinv[j, l] (3 terms).
        wv = (
            w_cell[..., 0, None] * vinv_g[..., None, 0, :]
            + w_cell[..., 1, None] * vinv_g[..., None, 1, :]
            + w_cell[..., 2, None] * vinv_g[..., None, 2, :]
        )
        coupling = jnp.einsum("ckil,ckml->cim", wv, w_cell)
        precond_mat = u_d - coupling
        u_chol = guarded_block_cholesky(precond_mat, u_d)
    else:
        precond_mat = u_d
        u_chol = jax.vmap(jnp.linalg.cholesky)(precond_mat)

    return GridNormal(
        u=u_d,
        v_inv=v_inv,
        u_chol=u_chol,
        g_cam=g_cam,
        g_pt=g_pt,
        damp_cam=damp_cam,
        damp_pt=damp_pt,
        jc=blocks.jc,
        jp=blocks.jp,
        jp_g=jp_g,
        jc_g=jc_g,
    )


def w_times(nb: GridNormal, y_pt: jax.Array, problem: BAGridProblem) -> jax.Array:
    """(W y)_c — all dense: gather y onto the grid, two tiny contractions."""
    tmp = jnp.sum(nb.jp * y_pt[problem.pt_idx][:, :, None, :], axis=-1)
    return jnp.einsum("ckri,ckr->ci", nb.jc, tmp)


def wt_times(nb: GridNormal, x_cam: jax.Array, problem: BAGridProblem) -> jax.Array:
    """(W^T x)_p — gathers x (a tiny (C,8) table) by the
    per-track camera index instead of gathering a large intermediate, then
    reduces densely over the track axis."""
    x_g = x_cam[problem.track_cam]  # (P, T, 8) from a tiny source
    s_g = jnp.sum(nb.jc_g * x_g[:, :, None, :], axis=-1)
    return jnp.sum(nb.jp_g * s_g[..., None], axis=(1, 2))


def schur_matvec(nb: GridNormal, x_cam: jax.Array, problem: BAGridProblem) -> jax.Array:
    ux = jnp.sum(nb.u * x_cam[:, None, :], axis=-1)
    wtx = wt_times(nb, x_cam, problem)
    vinv_wtx = jnp.sum(nb.v_inv * wtx[:, None, :], axis=-1)
    return ux - w_times(nb, vinv_wtx, problem)


def precond_apply(nb: GridNormal, r_cam: jax.Array) -> jax.Array:
    return jax.vmap(lambda ch, rr: jax.scipy.linalg.cho_solve((ch, True), rr))(
        nb.u_chol, r_cam
    )


def schur_pcg(
    nb: GridNormal, b_cam: jax.Array, problem: BAGridProblem,
    maxiter: int, rtol: float,
):
    out = pcg(
        lambda p: schur_matvec(nb, p, problem),
        lambda r: precond_apply(nb, r),
        b_cam, maxiter, rtol,
    )
    return out.x, out.iters


def ba_solve_grid(
    problem: BAGridProblem, config: BAConfig = BAConfig()
) -> Tuple[CameraParams, jax.Array, BAState]:
    """Grid-layout BA solve; returns the same (cameras, points, BAState)
    triple as ba_solve."""
    if config.optimize_pp:
        raise ValueError(
            "optimize_pp is supported by the track-table engines "
            "(ba_solve_tt / ba_solve_wtt) only"
        )
    if config.precond in ("tridiag", "ssor"):
        raise ValueError(
            f"precond={config.precond!r} is supported by the tt/wtt engines "
            "only (band preconditioners need the track-table pair one-hots)"
        )
    with jax.default_matmul_precision("highest"):
        return _ba_solve_grid_impl(problem, config)


def _ba_solve_grid_impl(problem, config):
    cams = problem.cameras
    dtype = problem.points3d.dtype

    def blocks_for(rmats, tvecs, fx_fy, points3d):
        b = grid_blocks(
            rmats, tvecs, fx_fy, cams.cx_cy_skew, cams.dist, points3d,
            problem, config.loss,
        )
        jc, jp = b.jc, b.jp
        if not config.optimize_focal:
            jc = jc.at[..., 6:8].set(0.0)
        if not config.optimize_points:
            jp = jp * 0.0
        return GridBlocks(r=b.r, jc=jc, jp=jp)

    def loss_of(r):
        return 0.5 * jnp.sum(r * r)

    b0 = blocks_for(cams.rmats, cams.tvecs, cams.fx_fy, problem.points3d)

    init = BAState(
        rmats=cams.rmats,
        tvecs=cams.tvecs,
        fx_fy=cams.fx_fy,
        points3d=problem.points3d,
        loss=loss_of(b0.r),
        lam=jnp.asarray(config.init_lambda, dtype),
        nu=jnp.asarray(2.0, dtype),
        iter_num=jnp.zeros((), jnp.int32),
        accepted=jnp.zeros((), jnp.int32),
        grad_norm=jnp.asarray(jnp.inf, dtype),
        converged=jnp.zeros((), bool),
        cg_iters=jnp.zeros((), jnp.int32),
        gain=jnp.zeros((), dtype),
    )

    def cond(state: BAState):
        return jnp.logical_and(state.iter_num < config.maxiter, ~state.converged)

    def body(state: BAState):
        blocks = blocks_for(state.rmats, state.tvecs, state.fx_fy, state.points3d)
        nb = build_grid_normal(blocks, problem, state.lam, precond=config.precond)
        grad_norm = jnp.maximum(
            jnp.max(jnp.abs(nb.g_cam)),
            jnp.max(jnp.abs(nb.g_pt)) if config.optimize_points else 0.0,
        )

        vinv_gp = jnp.sum(nb.v_inv * nb.g_pt[:, None, :], axis=-1)
        b = -nb.g_cam + w_times(nb, vinv_gp, problem)
        dc, cg_iters = schur_pcg(nb, b, problem, config.cg_maxiter, config.cg_rtol)
        dp = jnp.sum(
            nb.v_inv * (-nb.g_pt - wt_times(nb, dc, problem))[:, None, :],
            axis=-1,
        )
        if not config.optimize_points:
            dp = dp * 0.0

        new_r, new_t, new_f = apply_se3_retraction(
            state.rmats, state.tvecs, state.fx_fy, dc
        )
        new_pts = state.points3d + dp
        r_cand = blocks_for(new_r, new_t, new_f, new_pts).r
        loss_cand = loss_of(r_cand)

        pred = 0.5 * (
            jnp.sum(dc * (nb.damp_cam * dc))
            + jnp.sum(dp * (nb.damp_pt * dp))
            - jnp.sum(dc * nb.g_cam)
            - jnp.sum(dp * nb.g_pt)
        )
        pred = jnp.maximum(pred, jnp.asarray(1e-32, dtype))
        gain = (state.loss - loss_cand) / pred
        accept = jnp.logical_and(jnp.isfinite(loss_cand), loss_cand < state.loss)

        lam_acc = state.lam * jnp.maximum(
            jnp.asarray(1.0 / 3.0, dtype), 1.0 - (2.0 * gain - 1.0) ** 3
        )
        lam_new = jnp.clip(
            jnp.where(accept, lam_acc, state.lam * state.nu),
            config.min_lambda,
            config.max_lambda,
        )
        nu_new = jnp.where(accept, jnp.asarray(2.0, dtype), state.nu * 2.0)

        sel = lambda a, b_: jnp.where(accept, a, b_)
        rel_decrease = (state.loss - loss_cand) <= config.ftol * jnp.maximum(
            state.loss, jnp.asarray(1e-32, dtype)
        )
        converged = jnp.logical_or(
            grad_norm < config.gtol, jnp.logical_and(accept, rel_decrease)
        )

        return BAState(
            rmats=sel(new_r, state.rmats),
            tvecs=sel(new_t, state.tvecs),
            fx_fy=sel(new_f, state.fx_fy),
            points3d=sel(new_pts, state.points3d),
            loss=sel(loss_cand, state.loss),
            lam=lam_new,
            nu=nu_new,
            iter_num=state.iter_num + 1,
            accepted=state.accepted + accept.astype(jnp.int32),
            grad_norm=grad_norm,
            converged=converged,
            cg_iters=cg_iters,
            gain=gain,
        )

    final = jax.lax.while_loop(cond, body, init)
    cameras_out = CameraParams(
        rmats=final.rmats,
        tvecs=final.tvecs,
        fx_fy=final.fx_fy,
        cx_cy_skew=cams.cx_cy_skew,
        dist=cams.dist,
    )
    return cameras_out, final.points3d, final


_GRID_SOLVER_CACHE: dict = {}
_GRID_JIT_CACHE: dict = {}


def make_grid_ba_solver(config: BAConfig = BAConfig()):
    if config not in _GRID_SOLVER_CACHE:
        from tpu3drecon.solvers.bundle_adjust import (
            dynamic_operands,
            merge_dynamic_config,
            static_config,
        )

        static = static_config(config)
        jfn = _GRID_JIT_CACHE.get(static)
        if jfn is None:
            jfn = jax.jit(
                lambda p, d, s=static: ba_solve_grid(p, merge_dynamic_config(s, d))
            )
            _GRID_JIT_CACHE[static] = jfn
        _GRID_SOLVER_CACHE[config] = lambda p, _j=jfn, _c=config: _j(
            p, dynamic_operands(_c)
        )
    return _GRID_SOLVER_CACHE[config]
