"""Track-table BA engine vs the grid engine: packing, blocks, full solves."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu3drecon.dataset.synthetic import make_scene, perturb_scene, scene_to_ba_problem
from tpu3drecon.geometry.losses import RobustLoss
from tpu3drecon.problems.grid import grid_bucketed_from_flat, grid_from_flat
from tpu3drecon.problems.tt import tt_from_flat
from tpu3drecon.solvers.ba_grid import ba_solve_grid
from tpu3drecon.solvers.ba_tt import ba_solve_tt
from tpu3drecon.solvers.bundle_adjust import BAConfig, ba_solve, reprojection_rmse


@pytest.fixture(scope="module", params=[(0.0, 0.0), (-0.08, 0.012)], ids=["pinhole", "radial"])
def flat_problem(request):
    scene = make_scene(n_cameras=8, n_points=300, seed=7, dist=request.param)
    noisy = perturb_scene(scene, seed=8, point2d_noise=0.0)
    problem, _ = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float64)
    return problem


@pytest.fixture(scope="module")
def tt_problem(flat_problem):
    return tt_from_flat(flat_problem, point_block=64)


class TestTTPacking:
    def test_counts_preserved(self, flat_problem, tt_problem):
        n_real = int(np.array(flat_problem.mask).sum())
        total = sum(int(np.array(b.mask).sum()) for b in tt_problem.buckets)
        assert total == n_real
        onehot_total = sum(
            int(np.array(b.onehot, dtype=np.float64).sum()) for b in tt_problem.buckets
        )
        assert onehot_total == n_real

    def test_onehot_matches_cam_ids(self, tt_problem):
        for b in tt_problem.buckets:
            onehot = np.array(b.onehot)
            cam = np.array(b.cam_ids).reshape(-1)
            mask = np.array(b.mask).reshape(-1)
            # Each real slot selects exactly its camera; padding rows are 0.
            onehot = onehot.reshape(onehot.shape[0], -1)
            onehot = onehot.astype(np.float64)
            assert np.array_equal(onehot.sum(axis=0), (mask > 0).astype(np.float64))
            rows = onehot.argmax(axis=0)
            np.testing.assert_array_equal(rows[mask > 0], cam[mask > 0])

    def test_uv_slots_match_grid(self, flat_problem, tt_problem):
        # Every (camera, uv) pair of the flat problem appears exactly once
        # across the track-table buckets.
        fmask = np.array(flat_problem.mask) > 0
        flat_pairs = {
            (int(c), round(float(u), 9), round(float(v), 9))
            for c, (u, v) in zip(
                np.array(flat_problem.cam_idx)[fmask], np.array(flat_problem.uv)[fmask]
            )
        }
        tt_pairs = set()
        for b in tt_problem.buckets:
            uv = np.array(b.uv)
            cam = np.array(b.cam_ids)
            mask = np.array(b.mask) > 0
            for t, p in zip(*np.nonzero(mask)):
                tt_pairs.add(
                    (int(cam[t, p]), round(float(uv[0, t, p]), 9), round(float(uv[1, t, p]), 9))
                )
        assert tt_pairs == flat_pairs

    def test_size_guard(self, flat_problem):
        with pytest.raises(ValueError, match="one-hot"):
            tt_from_flat(flat_problem, point_block=64, max_onehot_bytes=16)


@pytest.mark.parametrize(
    "loss,precond",
    [
        (RobustLoss.TRIVIAL, "jacobi_u"),
        (RobustLoss.TRIVIAL, "schur_jacobi"),
        (RobustLoss.CAUCHY, "schur_jacobi"),
    ],
)
class TestTTSolveEquality:
    def test_matches_grid_engine(self, flat_problem, tt_problem, loss, precond):
        config = BAConfig(
            maxiter=5, gtol=0.0, ftol=0.0, cg_maxiter=16, cg_rtol=1e-10,
            loss=loss, precond=precond,
        )
        grid_problem = grid_from_flat(flat_problem)
        cams_g, pts_g, st_g = ba_solve_grid(grid_problem, config)
        cams_t, pts_t, st_t = ba_solve_tt(tt_problem, config)

        assert int(st_t.accepted) == int(st_g.accepted)
        # atol floor: on this noiseless problem both engines drive the loss
        # to ~1e-26 (f64 rounding of zero) where rtol is meaningless.
        np.testing.assert_allclose(
            float(st_t.loss), float(st_g.loss), rtol=1e-6, atol=1e-18
        )
        np.testing.assert_allclose(
            np.array(cams_t.rmats), np.array(cams_g.rmats), atol=1e-6
        )
        np.testing.assert_allclose(
            np.array(cams_t.tvecs), np.array(cams_g.tvecs), atol=1e-6
        )
        np.testing.assert_allclose(
            np.array(cams_t.fx_fy), np.array(cams_g.fx_fy), rtol=1e-6
        )
        np.testing.assert_allclose(
            np.array(pts_t), np.array(pts_g), atol=1e-6
        )


class TestTTSolveModes:
    def test_pose_only(self, flat_problem, tt_problem):
        config = BAConfig(
            maxiter=5, gtol=0.0, ftol=0.0, cg_maxiter=25, cg_rtol=1e-10,
            optimize_points=False,
        )
        _, pts_t, st_t = ba_solve_tt(tt_problem, config)
        _, pts_f, st_f = ba_solve(flat_problem, config)
        np.testing.assert_allclose(float(st_t.loss), float(st_f.loss), rtol=1e-8)
        np.testing.assert_allclose(np.array(pts_t), np.array(pts_f), atol=1e-12)

    def test_frozen_focal(self, flat_problem, tt_problem):
        config = BAConfig(
            maxiter=5, gtol=0.0, ftol=0.0, cg_maxiter=25, cg_rtol=1e-10,
            optimize_focal=False,
        )
        cams_t, _, st_t = ba_solve_tt(tt_problem, config)
        cams_f, _, st_f = ba_solve(flat_problem, config)
        np.testing.assert_allclose(float(st_t.loss), float(st_f.loss), rtol=1e-8)
        np.testing.assert_allclose(
            np.array(cams_t.fx_fy), np.array(flat_problem.cameras.fx_fy)
        )
        np.testing.assert_allclose(
            np.array(cams_t.tvecs), np.array(cams_f.tvecs), atol=1e-8
        )

    def test_converges_to_gt_rmse(self, flat_problem, tt_problem):
        config = BAConfig(maxiter=25, cg_maxiter=50, cg_rtol=1e-8)
        cams, pts, state = ba_solve_tt(tt_problem, config)
        rmse = float(reprojection_rmse(flat_problem, cams, pts))
        assert rmse < 1e-6

    def test_joint_distortion_recovers_gt(self):
        # GT cameras carry barrel distortion; the problem starts at k=(0,0).
        # Joint 10-param blocks must recover it (the alternating
        # intrinsics_refine loop only converges linearly on this).
        import dataclasses

        gt_dist = (-0.08, 0.012)
        scene = make_scene(n_cameras=10, n_points=600, seed=11, dist=gt_dist)
        flat, _ = scene_to_ba_problem(scene, observed=scene, dtype=jnp.float64)
        cams0 = dataclasses.replace(
            flat.cameras, dist=jnp.zeros_like(flat.cameras.dist)
        )
        flat0 = dataclasses.replace(flat, cameras=cams0)
        tt = tt_from_flat(flat0, point_block=64)
        config = BAConfig(maxiter=30, cg_maxiter=40, cg_rtol=1e-10, optimize_dist=True)
        cams, pts, state = ba_solve_tt(tt, config)
        rmse = float(reprojection_rmse(flat, cams, pts))
        assert rmse < 1e-8
        np.testing.assert_allclose(
            np.array(cams.dist), np.tile(gt_dist, (10, 1)), atol=1e-6
        )

    def test_distortion_gradient_matches_ad(self, tt_problem):
        # With TRIVIAL loss, g_cam = J^T r exactly equals d(cost)/d(params)
        # for the additive params — pin the analytic k1/k2 (and focal)
        # Jacobian columns against jax.grad of the independent cost.
        from tpu3drecon.solvers.ba_tt import _cost, _linearize

        config = BAConfig(loss=RobustLoss.TRIVIAL, optimize_dist=True)
        cams = tt_problem.cameras
        dist0 = cams.dist + 0.01  # off-zero so the chain rule is non-trivial
        pts_list = tuple(
            tt_problem.points3d[off : off + b.mask.shape[1]].T
            for b, off in zip(tt_problem.buckets, tt_problem.bucket_offsets)
        )
        ccs = cams.cx_cy_skew
        params = (cams.rmats, cams.tvecs, cams.fx_fy, dist0, ccs, pts_list)
        nb = _linearize(params, jnp.asarray(0.0), tt_problem, config)

        def cost_of(fx_fy, dist):
            return _cost(
                (cams.rmats, cams.tvecs, fx_fy, dist, ccs, pts_list),
                tt_problem, config,
            )

        g_f, g_d = jax.grad(cost_of, argnums=(0, 1))(cams.fx_fy, dist0)
        np.testing.assert_allclose(
            np.array(nb.g_cam[:, 6:8]), np.array(g_f), rtol=1e-9, atol=1e-12
        )
        np.testing.assert_allclose(
            np.array(nb.g_cam[:, 8:10]), np.array(g_d), rtol=1e-9, atol=1e-12
        )

    def test_pp_gradient_matches_ad(self, tt_problem):
        # Pin the analytic cx/cy Jacobian columns against jax.grad of the
        # independent cost (optimize_pp adds the last 2 block columns).
        from tpu3drecon.solvers.ba_tt import _cost, _linearize

        config = BAConfig(loss=RobustLoss.TRIVIAL, optimize_pp=True)
        cams = tt_problem.cameras
        ccs0 = cams.cx_cy_skew + jnp.asarray([1.5, -2.0, 0.0])
        pts_list = tuple(
            tt_problem.points3d[off : off + b.mask.shape[1]].T
            for b, off in zip(tt_problem.buckets, tt_problem.bucket_offsets)
        )
        params = (cams.rmats, cams.tvecs, cams.fx_fy, cams.dist, ccs0, pts_list)
        nb = _linearize(params, jnp.asarray(0.0), tt_problem, config)
        assert nb.g_cam.shape[1] == 10  # 8 + pp

        def cost_of(ccs):
            return _cost(
                (cams.rmats, cams.tvecs, cams.fx_fy, cams.dist, ccs, pts_list),
                tt_problem, config,
            )

        g_c = jax.grad(cost_of)(ccs0)
        np.testing.assert_allclose(
            np.array(nb.g_cam[:, 8:10]), np.array(g_c[:, :2]),
            rtol=1e-9, atol=1e-12,
        )

    def test_pp_recovers_gt(self):
        # GT principal points are perturbed away in the initial cameras;
        # optimize_pp must pull them back (cx/cy are frozen in the
        # reference: src/reconstruction/bundle_adjustment/utils.py:47-57).
        import dataclasses

        scene = make_scene(n_cameras=10, n_points=600, seed=17)
        flat, _ = scene_to_ba_problem(scene, observed=scene, dtype=jnp.float64)
        rng = np.random.default_rng(23)
        delta = np.zeros((10, 3))
        delta[:, :2] = rng.normal(scale=3.0, size=(10, 2))  # pixels
        gt_ccs = np.array(flat.cameras.cx_cy_skew)
        cams0 = dataclasses.replace(
            flat.cameras,
            cx_cy_skew=jnp.asarray(gt_ccs + delta),
        )
        flat0 = dataclasses.replace(flat, cameras=cams0)
        tt = tt_from_flat(flat0, point_block=64)
        config = BAConfig(
            maxiter=30, cg_maxiter=40, cg_rtol=1e-10, optimize_pp=True
        )
        cams, pts, state = ba_solve_tt(tt, config)
        rmse = float(reprojection_rmse(flat, cams, pts))
        assert rmse < 1e-7
        # pp itself is gauge-coupled with rotation at this scale; assert it
        # moved toward GT rather than exact recovery.
        err0 = np.abs(delta[:, :2]).mean()
        err1 = np.abs(np.array(cams.cx_cy_skew)[:, :2] - gt_ccs[:, :2]).mean()
        assert err1 < 0.2 * err0

    def test_pp_rejected_by_other_engines(self, flat_problem):
        from tpu3drecon.solvers.bundle_adjust import ba_solve

        with pytest.raises(ValueError, match="optimize_pp"):
            ba_solve(flat_problem, BAConfig(optimize_pp=True))

    def test_jit_solver_cache(self, tt_problem):
        from tpu3drecon.solvers.ba_tt import make_tt_ba_solver

        config = BAConfig(maxiter=3, cg_maxiter=10)
        s1 = make_tt_ba_solver(config)
        s2 = make_tt_ba_solver(config)
        assert s1 is s2
        cams, pts, state = s1(tt_problem)
        assert bool(jnp.isfinite(state.loss))
