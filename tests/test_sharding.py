"""Multi-device sharded BA tests on the virtual 8-device CPU mesh.

The distributed coverage the reference entirely lacks (SURVEY.md §4
"multi-node testing: none"): the sharded solve must produce the same result
as the single-device solve, for several mesh sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu3drecon.dataset.synthetic import make_scene, perturb_scene, scene_to_ba_problem
from tpu3drecon.parallel.mesh import make_mesh, shard_ba_problem
from tpu3drecon.parallel.sharded_ba import ba_solve_sharded, make_sharded_ba_solver
from tpu3drecon.solvers.bundle_adjust import BAConfig, ba_solve, reprojection_rmse


@pytest.fixture(scope="module")
def problem():
    scene = make_scene(n_cameras=10, n_points=400, seed=31)
    noisy = perturb_scene(scene, seed=32, point2d_noise=0.0)
    problem, _ = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float64)
    return problem


CONFIG = BAConfig(maxiter=25, gtol=1e-12, cg_maxiter=100, cg_rtol=1e-8)


@pytest.fixture(scope="module")
def single_result(problem):
    return ba_solve(problem, CONFIG)


def test_eight_devices_available():
    assert len(jax.devices()) == 8, "conftest must provide the virtual CPU mesh"


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_sharded_matches_single_device(problem, single_result, n_devices):
    mesh = make_mesh(n_devices)
    cams_s, pts_s, state_s = ba_solve_sharded(problem, CONFIG, mesh=mesh)
    cams_1, pts_1, state_1 = single_result
    # Same accepted-step trajectory and near-identical optimum (fp reduction
    # order differs across shard counts, so exact bitwise equality is not
    # expected in general).
    np.testing.assert_allclose(np.array(pts_s), np.array(pts_1), atol=1e-6)
    np.testing.assert_allclose(np.array(cams_s.tvecs), np.array(cams_1.tvecs), atol=1e-6)
    rmse_s = float(reprojection_rmse(problem, cams_s, pts_s))
    assert rmse_s < 1e-5


def test_sharded_convergence_metrics(problem):
    mesh = make_mesh(8)
    cams, pts, state = ba_solve_sharded(problem, CONFIG, mesh=mesh)
    assert bool(np.array(state.converged)) or int(np.array(state.iter_num)) == CONFIG.maxiter
    assert int(np.array(state.accepted)) > 0
    assert float(reprojection_rmse(problem, cams, pts)) < 1e-5


def test_problem_placement(problem):
    mesh = make_mesh(4)
    placed = shard_ba_problem(problem, mesh)
    # Obs arrays sharded over 4 devices, camera arrays replicated.
    assert len(placed.uv.sharding.device_set) == 4
    assert placed.uv.sharding.is_fully_replicated is False
    assert placed.cameras.rmats.sharding.is_fully_replicated is True


def test_solver_reuse_same_executable(problem):
    mesh = make_mesh(2)
    solver = make_sharded_ba_solver(mesh, CONFIG)
    placed = shard_ba_problem(problem, mesh)
    c1, p1, s1 = solver(placed)
    c2, p2, s2 = solver(placed)  # cache hit; identical results
    np.testing.assert_array_equal(np.array(p1), np.array(p2))


def test_bal_class_shapes_dry_run():
    # BAL-Ladybug-style ratio (many points, few cams) scaled for the CPU
    # mesh: validates the sharded solve at high point-to-camera ratios
    # (BASELINE.json config #5 dry-run; full scale runs on the cards).
    from tpu3drecon.dataset.synthetic import make_scene, perturb_scene, scene_to_ba_problem

    scene = make_scene(n_cameras=40, n_points=20_000, obs_per_camera=600, seed=99)
    noisy = perturb_scene(scene, seed=100, point2d_noise=0.0)
    problem, _ = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float32)
    mesh = make_mesh(8)
    config = BAConfig(maxiter=4, gtol=0.0, cg_maxiter=20, cg_rtol=1e-3)
    cams, pts, state = ba_solve_sharded(problem, config, mesh=mesh)
    assert np.all(np.isfinite(np.array(pts)))
    rmse0 = float(reprojection_rmse(problem, problem.cameras, problem.points3d))
    rmse1 = float(reprojection_rmse(problem, cams, pts))
    assert rmse1 < 0.5 * rmse0


def test_sharded_pose_refinement_batch_dp():
    # Frame-batch data parallelism for the tracking config: results must
    # match the single-device vmapped refiner.
    from tpu3drecon.dataset.synthetic import make_scene, perturb_scene, scene_to_pose_problem
    from tpu3drecon.parallel.sharded_pose import refine_poses_sharded
    from tpu3drecon.solvers.lm_core import LMConfig
    from tpu3drecon.solvers.pose_refine import refine_poses

    scene = make_scene(n_cameras=16, n_points=300, obs_per_camera=150, seed=121)
    noisy = perturb_scene(
        scene, point3d_noise=0.0, camera_rotation_noise=1e-2,
        camera_translation_noise=3e-2, camera_intrinsics_noise=0.0,
        point2d_noise=0.0, seed=122,
    )
    problem, _ = scene_to_pose_problem(noisy, observed=scene, dtype=jnp.float64)
    config = LMConfig(maxiter=50, gtol=1e-12)
    mesh = make_mesh(8)
    cams_s, state_s = refine_poses_sharded(problem, mesh=mesh, config=config)
    cams_1, state_1 = refine_poses(problem, config=config)
    np.testing.assert_allclose(
        np.array(cams_s.tvecs), np.array(cams_1.tvecs), atol=1e-9
    )
    assert len(cams_s.rmats.sharding.device_set) == 8
