"""Multi-chip sharded bundle adjustment walkthrough.

Shards the observation axis over every available device (the cards of one
host, or the virtual CPU mesh for local testing).

Run: python examples/sharded_ba.py [--devices N]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import time

import jax
import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--cameras", type=int, default=40)
    ap.add_argument("--points", type=int, default=20000)
    args = ap.parse_args()

    from tpu3drecon.dataset.synthetic import (
        make_scene,
        perturb_scene,
        scene_to_ba_problem,
    )
    from tpu3drecon.parallel.mesh import make_mesh, shard_ba_problem
    from tpu3drecon.parallel.sharded_ba import make_sharded_ba_solver
    from tpu3drecon.solvers.bundle_adjust import BAConfig, reprojection_rmse

    scene = make_scene(
        n_cameras=args.cameras, n_points=args.points, obs_per_camera=600, seed=0
    )
    noisy = perturb_scene(scene, seed=1)
    problem, _ = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float32)

    mesh = make_mesh(args.devices)
    print(f"mesh: {mesh.devices.size} x {mesh.devices.flat[0].platform}")
    placed = shard_ba_problem(problem, mesh)
    solver = make_sharded_ba_solver(mesh, BAConfig(maxiter=40, gtol=1e-6))

    t0 = time.perf_counter()
    cams, pts, state = solver(placed)
    jax.device_get(state.loss)
    print(f"first call (compile+run) {time.perf_counter()-t0:.2f}s")
    t0 = time.perf_counter()
    cams, pts, state = solver(placed)
    jax.device_get(state.loss)
    print(f"steady-state solve {time.perf_counter()-t0:.3f}s, "
          f"{int(jax.device_get(state.iter_num))} iters, "
          f"RMSE {float(reprojection_rmse(problem, cams, pts)):.5f}px")


if __name__ == "__main__":
    main()
