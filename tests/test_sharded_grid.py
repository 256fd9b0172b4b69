"""Sharded bucketed-grid BA vs single-device engines (virtual CPU mesh)."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu3drecon.dataset.synthetic import make_scene, perturb_scene, scene_to_ba_problem
from tpu3drecon.parallel.mesh import make_mesh
from tpu3drecon.parallel.sharded_grid import ba_solve_grid_sharded, pad_cameras_for_mesh
from tpu3drecon.problems.grid import grid_bucketed_from_flat
from tpu3drecon.solvers.bundle_adjust import BAConfig, ba_solve, reprojection_rmse


@pytest.fixture(scope="module")
def problem_pair():
    # point_block=128 keeps bucket padding small at test scale while still
    # divisible by 8 devices.
    scene = make_scene(n_cameras=8, n_points=400, seed=91)
    noisy = perturb_scene(scene, seed=92, point2d_noise=0.0)
    flat, _ = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float64)
    grid = grid_bucketed_from_flat(flat, point_block=128)
    return flat, grid


CONFIG = BAConfig(maxiter=15, gtol=1e-14, cg_maxiter=40, cg_rtol=1e-10)


class TestShardedGrid:
    @pytest.mark.parametrize("n_devices", [2, 4, 8])
    def test_matches_single_device_flat(self, problem_pair, n_devices):
        flat, grid = problem_pair
        mesh = make_mesh(n_devices)
        cams_s, pts_s, st_s = ba_solve_grid_sharded(grid, CONFIG, mesh=mesh)
        cams_1, pts_1, st_1 = ba_solve(flat, CONFIG)
        # psum reduction order differs from the serial sum, so the trajectory
        # can split by one accept/reject near convergence — same standard as
        # tests/test_sharding.py (agreement to 1e-6, not bit equality).
        assert abs(int(st_s.accepted) - int(st_1.accepted)) <= 1
        np.testing.assert_allclose(np.asarray(pts_s), np.asarray(pts_1), atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(cams_s.tvecs)[: flat.n_cameras],
            np.asarray(cams_1.tvecs),
            atol=1e-6,
        )

    def test_matches_flat_solve_quality(self, problem_pair):
        flat, grid = problem_pair
        mesh = make_mesh(8)
        cams_s, pts_s, st_s = ba_solve_grid_sharded(grid, CONFIG, mesh=mesh)
        cams_f, pts_f, st_f = ba_solve(flat, CONFIG)
        c = flat.n_cameras
        import dataclasses

        cams_eval = dataclasses.replace(
            cams_s,
            rmats=cams_s.rmats[:c],
            tvecs=cams_s.tvecs[:c],
            fx_fy=cams_s.fx_fy[:c],
            cx_cy_skew=cams_s.cx_cy_skew[:c],
            dist=cams_s.dist[:c],
        )
        rmse_s = float(reprojection_rmse(flat, cams_eval, pts_s))
        rmse_f = float(reprojection_rmse(flat, cams_f, pts_f))
        assert rmse_s < max(2.0 * rmse_f, 1e-8)

    def test_camera_padding_inert(self, problem_pair):
        _, grid = problem_pair
        padded = pad_cameras_for_mesh(grid, 16)  # 8 cams -> pad to 16
        assert padded.n_cameras == 16
        assert float(np.asarray(padded.mask)[8:].sum()) == 0.0
        # Determinants of padding rotations are 1 (valid SO(3)).
        dets = np.linalg.det(np.asarray(padded.cameras.rmats)[8:])
        np.testing.assert_allclose(dets, 1.0, atol=1e-12)
