"""Bundle adjustment: LM with implicit Schur complement, fully on-chip.

Accelerator-resident replacement for the reference's jaxopt dense-Jacobian BA
(reference: src/reconstruction/bundle_adjustment/bundle_adjustment.py +
jaxopt LevenbergMarquardt): jointly optimizes all camera poses (SE(3) local
parameterization), focal lengths, and 3D points.  One outer
``lax.while_loop`` iteration does

  1. analytic per-observation blocks (ops/jacobians.py) — no AD, no dense J;
  2. segment-sum accumulation of damped U/V blocks and gradients (schur.py);
  3. matrix-free preconditioned-CG solve of the reduced camera system;
  4. point back-substitution, SE(3) retraction, trust-region accept/reject
     with Nielsen lambda control (same scheme as lm_core).

The whole solve compiles to a single XLA executable.  Memory is O(N_obs)
(the 8x3 W blocks dominate) instead of the reference's
O(N_obs * (8C + 3P)) dense Jacobian — the difference between its
15-camera/400-point ceiling (benchmark_impl_bundle_adjustment.py:28-29) and
BAL-scale problems.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from tpu3drecon.geometry.losses import RobustLoss
from tpu3drecon.ops.jacobians import apply_se3_retraction, gather_obs_blocks
from tpu3drecon.problems.packing import BAProblem, CameraParams
from tpu3drecon.solvers import schur


class BAConfig(NamedTuple):
    """Outer-LM + inner-CG configuration."""

    maxiter: int = 50
    gtol: float = 1e-8  # inf-norm of the (whitened) gradient
    ftol: float = 1e-12  # relative cost decrease on accepted steps
    init_lambda: float = 1e-4
    min_lambda: float = 1e-32
    max_lambda: float = 1e32
    cg_maxiter: int = 100
    cg_rtol: float = 1e-5
    loss: RobustLoss = RobustLoss.TRIVIAL
    optimize_focal: bool = True
    optimize_points: bool = True  # False -> pose-only (motion-only) BA
    # Jointly optimize the radial distortion (k1, k2) as part of each camera
    # block (10 params/cam instead of 8).  Supported by the track-table
    # engine (solvers/ba_tt.py) — the BAL-style joint refinement that the
    # alternating intrinsics_refine loop only approaches linearly.
    optimize_dist: bool = False
    # Jointly optimize the principal point (cx, cy) as part of each camera
    # block (+2 params/cam).  Track-table engines (tt/wtt) only.  Exceeds
    # the reference, which freezes cx/cy/skew unconditionally
    # (src/reconstruction/bundle_adjustment/utils.py:47-57); SIMPLE_RADIAL
    # real data often needs pp refinement.
    optimize_pp: bool = False
    # CG preconditioner for the reduced camera system:
    #   "jacobi_u":     block-Jacobi on damped U (ignores point-elimination fill)
    #   "schur_jacobi": exact diagonal blocks of S = U - W V^-1 W^T (Ceres'
    #                   SCHUR_JACOBI) — costs one extra v_inv gather per
    #                   linearization, typically halves CG iterations.
    #   "tridiag":      exact block-TRIDIAGONAL of S (diag + S_{c,c+1} from
    #                   adjacent track-slot pairs; solvers/tridiag.py) —
    #                   tt/wtt engines only; targets sequential captures
    #                   where adjacent-camera coupling dominates.  Large
    #                   camera chains factor/solve in independent segments
    #                   (tridiag.auto_segments) to bound sequential depth.
    #                   CAUTION: the tridiagonal PART of SPD S is often
    #                   indefinite — measured WORSE than schur_jacobi on
    #                   larger sequential scenes (experiments/
    #                   precond_quality.py); prefer "ssor".
    #   "ssor":         block-SSOR (D+L) D^-1 (D+L)^T over the same exact
    #                   D and S_{c,c+1} band — SPD by construction, no
    #                   guard; measured 1.7x fewer PCG iters than
    #                   schur_jacobi on sequential scenes.  tt/wtt only.
    #                   Wall-clock guidance from the earlier accelerator
    #                   (RESULTS.md): schur_jacobi wins at 100-256 cams,
    #                   ssor at BAL scale (>=~1000 cams, sequential).  Not
    #                   yet re-measured on the H100.
    precond: str = "schur_jacobi"
    # Track-table engines: store the per-slot jc/jp Jacobian planes used by
    # the CG matvec / rhs / back-substitution in bfloat16 (the U/V/coupling
    # reductions inside the linearization stay f32).  The CG matvec streams
    # are the dominant memory term at BAL scale, and jc/jp are half of that
    # stream; CG runs inexact (fixed budget) anyway, so a ~0.4% matvec
    # perturbation costs little step quality.  Off by default.
    matvec_bf16: bool = False


def n_cam_params(config: "BAConfig") -> int:
    """Per-camera parameter-block width: pose(6) + focal(2) [+ k1,k2]
    [+ cx,cy].  Column order: so3 | t | fx fy | dist | pp."""
    return 8 + 2 * bool(config.optimize_dist) + 2 * bool(config.optimize_pp)


class DynamicBAParams(NamedTuple):
    """The BAConfig fields that are pure runtime scalars inside the
    compiled program (loop bounds and tolerances).  Passing them as jnp
    operands instead of baked constants lets ONE compiled executable serve
    every hyperparameter setting — at BAL scale a compile costs minutes,
    so sweeping maxiter/cg settings must not recompile."""

    maxiter: jax.Array
    gtol: jax.Array
    ftol: jax.Array
    init_lambda: jax.Array
    cg_maxiter: jax.Array
    cg_rtol: jax.Array


_DYN_SENTINEL = dict(
    maxiter=-1, gtol=-1.0, ftol=-1.0, init_lambda=-1.0, cg_maxiter=-1,
    cg_rtol=-1.0,
)


def static_config(config: "BAConfig") -> "BAConfig":
    """The jit-cache key: config with dynamic fields replaced by sentinels.
    Pure Python — safe to call before the jax backend is pinned."""
    return config._replace(**_DYN_SENTINEL)


_DYN_OPERAND_CACHE: dict = {}


def dynamic_operands(config: "BAConfig") -> "DynamicBAParams":
    """Concrete operand arrays for the dynamic fields (memoized per config).

    NOTE: creating these arrays initializes the jax backend, which pins the
    platform (CLAUDE.md trap) — the make_*_solver factories therefore call
    this at solver CALL time, not construction time, so a caller can still
    switch to CPU after building a solver.
    """
    import jax.numpy as jnp

    # Keyed by the x64 flag too: operands made under x64 are f64, and one
    # process may run f32 solves beside an f64 reference.
    key = (config, bool(jax.config.jax_enable_x64))
    dyn = _DYN_OPERAND_CACHE.get(key)
    if dyn is None:
        # Float tolerances keep the default float width (f64 under x64, f32
        # otherwise) so the dynamic path rounds identically to baked constants.
        dyn = DynamicBAParams(
            maxiter=jnp.asarray(config.maxiter, jnp.int32),
            gtol=jnp.asarray(float(config.gtol)),
            ftol=jnp.asarray(float(config.ftol)),
            init_lambda=jnp.asarray(float(config.init_lambda)),
            cg_maxiter=jnp.asarray(config.cg_maxiter, jnp.int32),
            cg_rtol=jnp.asarray(float(config.cg_rtol)),
        )
        _DYN_OPERAND_CACHE[key] = dyn
    return dyn


def split_dynamic_config(config: "BAConfig"):
    """(static_key, dynamic_operands): the static part keys the jit cache;
    the dynamic part rides in as arrays (see DynamicBAParams).  Creates
    concrete arrays NOW — use static_config + dynamic_operands separately to
    defer backend initialization (the sharded factories call this form: a
    mesh already implies initialized devices)."""
    return static_config(config), dynamic_operands(config)


def merge_dynamic_config(static: "BAConfig", dyn: DynamicBAParams) -> "BAConfig":
    """Rebuild a trace-time config whose dynamic fields are tracers."""
    return static._replace(**dyn._asdict())


class BAState(NamedTuple):
    rmats: jax.Array  # (C,3,3)
    tvecs: jax.Array  # (C,3)
    fx_fy: jax.Array  # (C,2)
    points3d: jax.Array  # (P,3)
    loss: jax.Array
    lam: jax.Array
    nu: jax.Array
    iter_num: jax.Array
    accepted: jax.Array
    grad_norm: jax.Array
    converged: jax.Array
    cg_iters: jax.Array  # last inner-CG iteration count
    gain: jax.Array


def _blocks_for(
    rmats, tvecs, fx_fy, cx_cy_skew, dist, points3d, problem: BAProblem, config: BAConfig
):
    # NOTE: blocks are per-observation (obs-local under sharding) — no
    # collective needed here; reductions happen in schur.build_normal_blocks.
    inv_w = 1.0 / problem.avg_cam_width
    blocks = gather_obs_blocks(
        rmats,
        tvecs,
        fx_fy,
        cx_cy_skew,
        dist,
        points3d,
        problem.cam_idx,
        problem.pt_idx,
        problem.uv,
        problem.mask,
        inv_w,
        config.loss,
    )
    r, jc, jp = blocks.residual, blocks.j_cam, blocks.j_pt
    if not config.optimize_focal:
        jc = jc.at[:, :, 6:8].set(0.0)
    if not config.optimize_points:
        jp = jp * 0.0
    return r, jc, jp


def _loss_of(r: jax.Array, axis_name: Optional[str] = None) -> jax.Array:
    loss = 0.5 * jnp.sum(r * r)
    return jax.lax.psum(loss, axis_name) if axis_name is not None else loss


def ba_solve(
    problem: BAProblem, config: BAConfig = BAConfig(),
    axis_name: Optional[str] = None,
) -> Tuple[CameraParams, jax.Array, BAState]:
    """Run BA on a packed problem; returns (cameras, points3d, state).

    Jit-safe: ``jax.jit(ba_solve, static_argnums=1)`` — or use the cached
    wrapper ``make_ba_solver``.  With ``axis_name`` set, runs inside
    shard_map with the observation axis sharded (tpu3drecon.parallel):
    cameras/points replicated, segment-sums psum-reduced, all trust-region
    decisions computed on replicated scalars so every device steps in
    lockstep.
    """
    if config.optimize_pp:
        raise ValueError(
            "optimize_pp is supported by the track-table engines "
            "(ba_solve_tt / ba_solve_wtt) only"
        )
    if config.precond in ("tridiag", "ssor"):
        raise ValueError(
            f"precond={config.precond!r} is supported by the tt/wtt "
            "engines only"
        )
    # Accelerator f32 matmuls default to reduced-precision inputs (TF32 on
    # the H100's tensor cores); the tiny 2x8/3x3 block algebra here is
    # bandwidth-bound anyway, so force true f32 — without this the f32
    # solve stalls orders of magnitude short (see
    # tests/test_bundle_adjust.py::test_float32's RMSE bar).
    with jax.default_matmul_precision("highest"):
        return _ba_solve_impl(problem, config, axis_name)


def _ba_solve_impl(
    problem: BAProblem, config: BAConfig, axis_name: Optional[str]
) -> Tuple[CameraParams, jax.Array, BAState]:
    cams = problem.cameras
    n_cameras = problem.n_cameras
    n_points = problem.n_points
    dtype = problem.points3d.dtype

    r0, _, _ = _blocks_for(
        cams.rmats, cams.tvecs, cams.fx_fy, cams.cx_cy_skew, cams.dist,
        problem.points3d, problem, config,
    )

    init = BAState(
        rmats=cams.rmats,
        tvecs=cams.tvecs,
        fx_fy=cams.fx_fy,
        points3d=problem.points3d,
        loss=_loss_of(r0, axis_name),
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
        r, jc, jp = _blocks_for(
            state.rmats,
            state.tvecs,
            state.fx_fy,
            cams.cx_cy_skew,
            cams.dist,
            state.points3d,
            problem,
            config,
        )
        nb = schur.build_normal_blocks(
            r,
            jc,
            jp,
            problem.cam_idx,
            problem.pt_idx,
            n_cameras,
            n_points,
            state.lam,
            axis_name=axis_name,
            precond=config.precond,
        )
        grad_norm = jnp.maximum(
            jnp.max(jnp.abs(nb.g_cam)),
            jnp.max(jnp.abs(nb.g_pt)) if config.optimize_points else 0.0,
        )

        # Reduced camera system RHS: b = -g_c + W V^{-1} g_p.
        vinv_gp = jnp.sum(nb.v_inv * nb.g_pt[:, None, :], axis=-1)
        b = -nb.g_cam + schur.w_times(
            nb, vinv_gp, problem.cam_idx, problem.pt_idx, n_cameras, axis_name
        )

        pcg = schur.schur_pcg(
            nb,
            b,
            problem.cam_idx,
            problem.pt_idx,
            maxiter=config.cg_maxiter,
            rtol=config.cg_rtol,
            axis_name=axis_name,
        )
        dc = pcg.x
        dp = schur.back_substitute_points(
            nb, dc, problem.cam_idx, problem.pt_idx, axis_name
        )
        if not config.optimize_points:
            dp = dp * 0.0

        # Candidate update via retraction.
        new_r, new_t, new_f = apply_se3_retraction(
            state.rmats, state.tvecs, state.fx_fy, dc
        )
        new_pts = state.points3d + dp

        r_cand, _, _ = _blocks_for(
            new_r, new_t, new_f, cams.cx_cy_skew, cams.dist, new_pts, problem, config
        )
        loss_cand = _loss_of(r_cand, axis_name)

        # Predicted reduction of the damped model:
        # 0.5 * (d^T (lam*D) d - d^T g) over both blocks.
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
            cg_iters=pcg.iters,
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


_SOLVER_CACHE: dict = {}
_JIT_CACHE: dict = {}


def make_ba_solver(config: BAConfig = BAConfig()):
    """Jitted BA solver for a fixed config (cached, zeros-compile friendly —
    the counterpart of the reference's JaxBundleAdjustment.compile warm-up,
    bundle_adjustment.py:122-129; bucketed problem shapes reuse the cache).
    Loop bounds/tolerances ride in as dynamic operands, so configs that
    differ only in those share one compiled executable."""
    if config not in _SOLVER_CACHE:
        static = static_config(config)
        jfn = _JIT_CACHE.get(static)
        if jfn is None:
            jfn = jax.jit(
                lambda p, d, s=static: ba_solve(p, merge_dynamic_config(s, d))
            )
            _JIT_CACHE[static] = jfn
        _SOLVER_CACHE[config] = lambda p, _j=jfn, _c=config: _j(
            p, dynamic_operands(_c)
        )
    return _SOLVER_CACHE[config]


def reprojection_rmse(problem: BAProblem, cameras: CameraParams, points3d: jax.Array) -> jax.Array:
    """Unwhitened pixel-space RMSE over real observations (evaluation metric,
    counterpart of Benchmark.reprojection_errors, benchmark.py:476-490)."""
    blocks = gather_obs_blocks(
        cameras.rmats,
        cameras.tvecs,
        cameras.fx_fy,
        cameras.cx_cy_skew,
        cameras.dist,
        points3d,
        problem.cam_idx,
        problem.pt_idx,
        problem.uv,
        problem.mask,
        jnp.asarray(1.0, problem.uv.dtype),  # no width normalization
        RobustLoss.TRIVIAL,
    )
    n = jnp.maximum(jnp.sum(problem.mask), 1.0)
    return jnp.sqrt(jnp.sum(blocks.residual**2) / (2.0 * n))
