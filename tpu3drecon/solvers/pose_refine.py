"""Batched single-camera pose (PnP) refinement on the accelerator.

Rebuilds the reference's single-pose pipeline (reference:
src/reconstruction/bundle_adjustment/pose_optimization.py) on the first-party
LM engine: per-camera parameters ``[rodrigues(3), t(3), fx, fy]`` with frozen
``cx, cy, skew``, masked width-normalized reprojection residuals, batched via
``vmap`` into one compiled executable (pose_optimization.py:71's
``jit(vmap(lm.run))`` pattern).

Two residual forms:
  - ``per_axis`` (default): standard 2-residuals-per-observation with robust
    IRLS whitening — the well-conditioned formulation (what Ceres solves);
  - ``scalar`` (reference-parity): one residual per point,
    sum_axis loss(obs, proj) * mask / width^2 — bit-matches the reference's
    ``PoseOptimization.get_residuals`` (pose_optimization.py:33-52) so
    convergence behavior can be compared 1:1.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from tpu3drecon.geometry.losses import RobustLoss, cauchy_loss, l2_loss, robust_weight
from tpu3drecon.geometry.projection import project_points
from tpu3drecon.geometry.rotations import (
    matrix_to_rodrigues_batch,
    rodrigues_to_matrix,
    rodrigues_to_matrix_batch,
)
from tpu3drecon.problems.packing import CameraParams, PoseProblem
from tpu3drecon.solvers.lm_core import LMConfig, LMState, lm_solve


def pose_params_pack(cameras: CameraParams) -> jax.Array:
    """(B, 8) LM parameter vectors [rodrigues | t | fx, fy] from cameras.

    Device-side counterpart of JaxPoseOptimizer.prepare_params
    (pose_optimization.py:73-84), which round-trips through host numpy.
    """
    rvecs = matrix_to_rodrigues_batch(cameras.rmats)
    return jnp.concatenate([rvecs, cameras.tvecs, cameras.fx_fy], axis=1)


def pose_params_unpack(
    params: jax.Array, cx_cy_skew: jax.Array, dist: jax.Array
) -> CameraParams:
    """(B, 8) parameter vectors -> CameraParams (frozen cx/cy/skew/dist)."""
    return CameraParams(
        rmats=rodrigues_to_matrix_batch(params[:, :3]),
        tvecs=params[:, 3:6],
        fx_fy=params[:, 6:8],
        cx_cy_skew=cx_cy_skew,
        dist=dist,
    )


def pose_residuals_per_axis(
    params: jax.Array,
    points3d: jax.Array,
    points2d: jax.Array,
    cx_cy_skew: jax.Array,
    dist: jax.Array,
    mask: jax.Array,
    avg_cam_width: jax.Array,
    loss: RobustLoss = RobustLoss.CAUCHY,
) -> jax.Array:
    """Whitened per-axis residuals, flattened to (2N,).

    r_i = (proj - obs) * sqrt(w(s_i)) * mask / width, with IRLS weights frozen
    per linearization (stop_gradient) so LM sees the Gauss-Newton structure of
    the robust objective.
    """
    rmat = rodrigues_to_matrix(params[:3])
    proj = project_points(rmat, params[3:6], params[6:8], cx_cy_skew, dist, points3d)
    r = proj - points2d
    s = jnp.sum(r * r, axis=1)
    w = robust_weight(loss, jax.lax.stop_gradient(s))
    return (r * (jnp.sqrt(w) * mask / avg_cam_width)[:, None]).reshape(-1)


def pose_residuals_scalar(
    params: jax.Array,
    points3d: jax.Array,
    points2d: jax.Array,
    cx_cy_skew: jax.Array,
    dist: jax.Array,
    mask: jax.Array,
    avg_cam_width_sqr: jax.Array,
    loss: RobustLoss = RobustLoss.CAUCHY,
) -> jax.Array:
    """Reference-parity scalar residuals (N,).

    Exactly pose_optimization.py:33-52: per-point sum over the two axes of
    loss(obs, proj), masked, divided by the squared average camera width.
    """
    rmat = rodrigues_to_matrix(params[:3])
    proj = project_points(rmat, params[3:6], params[6:8], cx_cy_skew, dist, points3d)
    if loss == RobustLoss.CAUCHY:
        res = cauchy_loss(points2d, proj)
    else:
        res = l2_loss(points2d, proj)
    return res.sum(axis=1) * mask / avg_cam_width_sqr


class PoseRefiner:
    """Batched PnP refiner — drop-in analog of the reference JaxPoseOptimizer
    (pose_optimization.py:55-99) with compile/optimize split preserved."""

    def __init__(
        self,
        avg_cam_width: float,
        loss: RobustLoss = RobustLoss.CAUCHY,
        residual_form: str = "per_axis",
        config: LMConfig = LMConfig(maxiter=100, gtol=1e-7),
    ):
        self.avg_cam_width = avg_cam_width
        self.loss = loss
        self.residual_form = residual_form
        self.config = config
        self.solver = self._build_solver()

    _JIT_CACHE: dict = {}

    def _build_solver(self):
        """Batched jitted solver, cached at class level by the STATIC part
        of the configuration: the camera-width norm, loop bounds, and
        tolerances ride in as operands, so refiners that differ only in
        those (or in avg_cam_width) share one compiled executable."""
        from tpu3drecon.solvers.lm_core import (
            dynamic_lm_operands,
            merge_dynamic_lm_config,
            static_lm_config,
        )

        # norm stays a Python float here; converted at call time so building
        # a refiner does not initialize the jax backend (platform pinning).
        if self.residual_form == "per_axis":
            norm = float(self.avg_cam_width)
            res_fn = functools.partial(
                pose_residuals_per_axis, loss=self.loss
            )
        elif self.residual_form == "scalar":
            norm = float(self.avg_cam_width**2)
            res_fn = functools.partial(pose_residuals_scalar, loss=self.loss)
        else:
            raise ValueError(f"unknown residual_form {self.residual_form!r}")

        static = static_lm_config(self.config)
        key = (self.loss, self.residual_form, static)
        jfn = PoseRefiner._JIT_CACHE.get(key)
        if jfn is None:
            def solve_one(params0, points3d, points2d, cx_cy_skew, dist, mask,
                          norm_in, d):
                return lm_solve(
                    res_fn,
                    params0,
                    points3d,
                    points2d,
                    cx_cy_skew,
                    dist,
                    mask,
                    norm_in.astype(params0.dtype),
                    config=merge_dynamic_lm_config(static, d),
                )

            jfn = jax.jit(
                jax.vmap(solve_one, in_axes=(0, 0, 0, 0, 0, 0, None, None))
            )
            PoseRefiner._JIT_CACHE[key] = jfn

        box = []  # operand arrays, created on first call (not construction)

        def solve(*a, _j=jfn, _n=norm, _c=self.config):
            if not box:
                box.append((jnp.asarray(_n), dynamic_lm_operands(_c)))
            n_arr, d = box[0]
            return _j(*a, n_arr, d)

        return solve

    def optimize(
        self, params0, points3d, points2d, cx_cy_skew, mask, dist=None
    ) -> Tuple[jax.Array, LMState]:
        if dist is None:
            dist = jnp.zeros((params0.shape[0], 2), params0.dtype)
        params, state = self.solver(
            params0, points3d, points2d, cx_cy_skew, dist, mask
        )
        return params.block_until_ready(), state

    def compile(self, points_num: int, batch_size: int = 8, dtype=jnp.float32):
        """Zeros-shaped warm-up compile (reference pose_optimization.py:91-99)."""
        self.optimize(
            jnp.concatenate(
                [
                    jnp.tile(jnp.asarray([[1e-3, 0, 0, 0, 0, 5.0]], dtype), (batch_size, 1)),
                    jnp.ones((batch_size, 2), dtype),
                ],
                axis=1,
            ),
            jnp.zeros((batch_size, points_num, 3), dtype),
            jnp.zeros((batch_size, points_num, 2), dtype),
            jnp.zeros((batch_size, 3), dtype),
            jnp.zeros((batch_size, points_num), dtype),
        )


def refine_poses(
    problem: PoseProblem,
    loss: RobustLoss = RobustLoss.CAUCHY,
    config: LMConfig = LMConfig(maxiter=100, gtol=1e-7),
    residual_form: str = "per_axis",
) -> Tuple[CameraParams, LMState]:
    """Functional one-call refinement of every camera in a PoseProblem."""
    refiner = PoseRefiner(
        float(problem.avg_cam_width), loss, residual_form, config
    )
    params0 = pose_params_pack(problem.cameras)
    params, state = refiner.optimize(
        params0,
        problem.points3d,
        problem.points2d,
        problem.cameras.cx_cy_skew,
        problem.mask,
        dist=problem.cameras.dist,
    )
    return (
        pose_params_unpack(params, problem.cameras.cx_cy_skew, problem.cameras.dist),
        state,
    )
