"""Distortion calibration walkthrough: recover k1/k2 nobody gave you.

A scene was captured with barrel-distorted lenses, but the initial model
claims pinhole (the common situation with SfM output that dropped the
distortion estimate).  Plain BA stalls — geometry cannot fully absorb radial
distortion — while the BA <-> intrinsics alternation recovers the
coefficients and the geometry together.

Usage: python examples/intrinsics_calibration.py   (JAX_PLATFORMS=cpu for the host)
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)  # calibration benefits from f64

import jax.numpy as jnp
import numpy as np


def main():
    from tpu3drecon.dataset.synthetic import make_scene, perturb_scene, scene_to_ba_problem
    from tpu3drecon.solvers.bundle_adjust import BAConfig, ba_solve, reprojection_rmse
    from tpu3drecon.solvers.intrinsics_refine import ba_with_intrinsics_calibration

    true_dist = (-0.12, 0.02)
    scene = make_scene(n_cameras=8, n_points=500, seed=301, dist=true_dist)
    noisy = perturb_scene(scene, seed=302, point2d_noise=0.0)
    problem, _ = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float64)
    # The init claims pinhole: distortion unknown.
    problem = dataclasses.replace(
        problem,
        cameras=dataclasses.replace(
            problem.cameras, dist=jnp.zeros_like(problem.cameras.dist)
        ),
    )
    print(f"ground-truth distortion: k1={true_dist[0]}, k2={true_dist[1]}")

    cams_ba, pts_ba, _ = ba_solve(problem, BAConfig(maxiter=40, gtol=1e-12))
    rmse_ba = float(reprojection_rmse(problem, cams_ba, pts_ba))
    print(f"pinhole-only BA:        RMSE {rmse_ba:.4f} px (stalls — distortion unmodeled)")

    cams, pts, state = ba_with_intrinsics_calibration(problem, rounds=16)
    rmse = float(reprojection_rmse(problem, cams, pts))
    k = np.asarray(cams.dist).mean(axis=0)
    print(
        f"BA + calibration (x16): RMSE {rmse:.4f} px, "
        f"recovered k1={k[0]:.3f}, k2={k[1]:.3f}"
    )


if __name__ == "__main__":
    main()
