"""Batched multi-frame tracking config (BASELINE.json config #4).

vmap LM over many frames with shared intrinsics structure: one compiled
executable, no per-frame recompiles.  CPU-scale version of the 500-frame
target (the full-scale number is produced by bench-time runs on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np

from tpu3drecon.dataset.synthetic import make_scene, perturb_scene, scene_to_pose_problem
from tpu3drecon.solvers.lm_core import LMConfig
from tpu3drecon.solvers.pose_refine import PoseRefiner, pose_params_pack


def test_many_frames_single_executable():
    # 32 frames on CPU — same code path as the 500-frame config.
    scene = make_scene(n_cameras=32, n_points=400, obs_per_camera=200, seed=81)
    noisy = perturb_scene(
        scene, point3d_noise=0.0, camera_rotation_noise=1e-2,
        camera_translation_noise=3e-2, camera_intrinsics_noise=0.0,
        point2d_noise=0.0, seed=82,
    )
    problem, _ = scene_to_pose_problem(noisy, observed=scene, dtype=jnp.float64)
    refiner = PoseRefiner(
        float(problem.avg_cam_width), config=LMConfig(maxiter=60, gtol=1e-12)
    )
    params0 = pose_params_pack(problem.cameras)

    with jax.log_compiles():
        params, state = refiner.optimize(
            params0, problem.points3d, problem.points2d,
            problem.cameras.cx_cy_skew, problem.mask,
        )
        # Second call with the same shapes must hit the jit cache.
        params, state = refiner.optimize(
            params0, problem.points3d, problem.points2d,
            problem.cameras.cx_cy_skew, problem.mask,
        )

    assert params.shape == (32, 8)
    # All frames converged to GT (noiseless observations).
    tvecs = np.array(params[:, 3:6])
    np.testing.assert_allclose(tvecs, scene.tvecs, atol=1e-3)


def test_batch_size_change_uses_bucketing():
    # Different frame counts, same max-points bucket: the solver function is
    # per-problem vmapped, so batch is a leading dim — recompile per batch
    # size is expected, but point-count bucketing keeps shapes stable across
    # datasets of similar size.
    from tpu3drecon.problems.packing import bucket_size

    assert bucket_size(801, 256) == bucket_size(1000, 256) == 1024
