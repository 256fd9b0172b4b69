"""End-to-end bundle adjustment walkthrough.

Script form of the reference's experiments notebooks (reference:
experiments/experiments.ipynb, experiments_gpu.ipynb — scipy and early-JAX
LM prototypes): build a scene, perturb it, solve, evaluate, export.

Run: python examples/bundle_adjustment.py [--colmap path/to/sparse]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--colmap", help="COLMAP sparse dir (default: synthetic scene)")
    ap.add_argument("--cameras", type=int, default=30)
    ap.add_argument("--points", type=int, default=3000)
    ap.add_argument("--export", help="export results as COLMAP model + PLY here")
    args = ap.parse_args()

    from tpu3drecon.solvers.bundle_adjust import (
        BAConfig,
        make_ba_solver,
        reprojection_rmse,
    )

    if args.colmap:
        from tpu3drecon.io import colmap as cio
        from tpu3drecon.problems.packing import ba_problem_from_colmap

        model = cio.read_model(args.colmap)
        problem, meta = ba_problem_from_colmap(model, dtype=jnp.float32)
        print(f"loaded {problem.n_cameras} cams / {problem.n_points} pts "
              f"/ {meta.n_real_obs} obs from {args.colmap}")
    else:
        from tpu3drecon.dataset.synthetic import (
            make_scene,
            perturb_scene,
            scene_to_ba_problem,
        )

        scene = make_scene(n_cameras=args.cameras, n_points=args.points, seed=0)
        noisy = perturb_scene(scene, seed=1)
        problem, meta = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float32)
        print(f"synthetic scene: {problem.n_cameras} cams / {problem.n_points} pts "
              f"/ {meta.n_real_obs} obs")

    rmse0 = float(reprojection_rmse(problem, problem.cameras, problem.points3d))
    solver = make_ba_solver(BAConfig(maxiter=50, gtol=1e-6, cg_rtol=1e-4))

    t0 = time.perf_counter()
    cams, pts, state = solver(problem)
    jax.device_get(state.loss)
    compile_and_run = time.perf_counter() - t0
    t0 = time.perf_counter()
    cams, pts, state = solver(problem)
    jax.device_get(state.loss)
    run = time.perf_counter() - t0

    rmse1 = float(reprojection_rmse(problem, cams, pts))
    print(f"RMSE {rmse0:.3f}px -> {rmse1:.5f}px in {int(state.iter_num)} iters "
          f"({int(state.accepted)} accepted)")
    print(f"compile {compile_and_run - run:.2f}s, solve {run:.3f}s "
          f"on {jax.default_backend()}")

    if args.export:
        from tpu3drecon.utils.visualization import write_ply_point_cloud

        write_ply_point_cloud(f"{args.export}_points.ply", np.asarray(jax.device_get(pts)))
        print(f"wrote {args.export}_points.ply")


if __name__ == "__main__":
    main()
