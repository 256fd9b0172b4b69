"""Full BAL pipeline at Ladybug-49 statistics: load -> solve -> evaluate -> export.

With no BAL download at hand, this runs the complete FILE-LEVEL pipeline on a
BAL problem with the published Ladybug-49 statistics (49 cameras, 7776
points, 31843 observations, BAL camera convention, radial distortion k1/k2,
noisy "-pre"-style initial geometry):

    write .txt  ->  ba_problem_from_bal  ->  ba_solve  ->  reprojection RMSE
                 ->  export_bal  ->  reload  ->  verify round trip

Swap ``--bal-file`` for a real problem-49-7776-pre.txt to run identical code
on the genuine dataset.

Usage: python examples/bal_pipeline.py [--bal-file path] [--f64]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

def make_ladybug49_like(path: str, seed: int = 49) -> None:
    """Synthesize a BAL file with Ladybug-49's shape using BAL's OWN camera
    model (p = -P/P.z, r(p) = 1 + k1|p|^2 + k2|p|^4), vehicle-arc cameras."""
    rng = np.random.default_rng(seed)
    n_cams, n_pts, target_obs = 49, 7776, 31843

    # Vehicle path: cameras along a gentle arc, looking sideways-down (the
    # Ladybug rig), points scattered along the corridor at street depth.
    s = np.linspace(0.0, 30.0, n_cams)
    cam_pos = np.stack([s, 0.1 * np.sin(s * 0.3), 0.02 * s], axis=1)
    points = np.stack(
        [
            rng.uniform(-3.0, 33.0, n_pts),
            rng.uniform(-4.0, 4.0, n_pts),
            rng.uniform(3.0, 14.0, n_pts),
        ],
        axis=1,
    )

    def rodrigues(rv):
        th = np.linalg.norm(rv)
        if th < 1e-12:
            return np.eye(3)
        k = rv / th
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)

    # BAL cameras look down -z; world points are at +z of the path, so the
    # camera frame needs z_cam < 0 for visible points: R = diag(1,1,-1)-ish
    # base orientation with small per-camera jitter, t = -R C.
    base = np.diag([1.0, -1.0, -1.0])
    rvecs = np.zeros((n_cams, 3))
    tvecs = np.zeros((n_cams, 3))
    rots = np.zeros((n_cams, 3, 3))
    for c in range(n_cams):
        jitter = rodrigues(rng.normal(scale=0.03, size=3))
        R = jitter @ base
        rots[c] = R
        tvecs[c] = -R @ cam_pos[c]
        # rodrigues vector of R
        ang = np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))
        axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        n = np.linalg.norm(axis)
        rvecs[c] = (ang / n) * axis if n > 1e-12 else np.zeros(3)

    f = 700.0 + rng.uniform(-20, 20, n_cams)
    k1 = np.full(n_cams, -0.33) + rng.normal(scale=0.01, size=n_cams)
    k2 = np.full(n_cams, 0.11) + rng.normal(scale=0.005, size=n_cams)

    # Observations: each camera sees the nearest points (track stats like the
    # real file: mean track ~4).
    per_cam = target_obs // n_cams
    cam_idx, pt_idx, uvs = [], [], []
    for c in range(n_cams):
        P = points @ rots[c].T + tvecs[c]
        visible = np.nonzero(P[:, 2] < -1.0)[0]
        d = np.abs(points[visible, 0] - cam_pos[c, 0])
        take = visible[np.argsort(d)[:per_cam]]
        Pc = P[take]
        p = -Pc[:, :2] / Pc[:, 2:3]
        r2 = np.sum(p * p, axis=1, keepdims=True)
        uv = f[c] * (1 + k1[c] * r2 + k2[c] * r2 * r2) * p
        inside = np.all(np.abs(uv) < 500, axis=1)
        cam_idx.append(np.full(inside.sum(), c, np.int32))
        pt_idx.append(take[inside].astype(np.int32))
        uvs.append(uv[inside] + rng.normal(scale=0.5, size=(inside.sum(), 2)))
    cam_idx = np.concatenate(cam_idx)
    pt_idx = np.concatenate(pt_idx)
    uvs = np.concatenate(uvs)

    # "-pre" style noisy initial geometry (what the solver starts from).
    rvecs_n = rvecs + rng.normal(scale=2e-3, size=rvecs.shape)
    tvecs_n = tvecs + rng.normal(scale=1e-2, size=tvecs.shape)
    points_n = points + rng.normal(scale=2e-2, size=points.shape)
    cam_params = np.concatenate(
        [rvecs_n, tvecs_n, f[:, None], k1[:, None], k2[:, None]], axis=1
    )

    from tpu3drecon.io.bal import write_bal

    write_bal(path, cam_idx, pt_idx, uvs, cam_params, points_n)
    print(
        f"wrote {path}: {len(cam_params)} cams, {len(points)} pts, "
        f"{len(cam_idx)} obs (mean track {len(cam_idx)/len(np.unique(pt_idx)):.1f})"
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bal-file", default=None, help="path to a real BAL file")
    ap.add_argument("--f64", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from tpu3drecon.io.bal import ba_problem_from_bal, export_bal
    from tpu3drecon.solvers.bundle_adjust import (
        BAConfig,
        make_ba_solver,
        reprojection_rmse,
    )

    path = args.bal_file
    if path is None:
        path = "/tmp/ladybug49_like.txt"
        make_ladybug49_like(path)

    dtype = jnp.float64 if args.f64 else jnp.float32
    problem, meta = ba_problem_from_bal(path, dtype=dtype)
    print(
        f"loaded: {problem.n_cameras} cams / {problem.n_points} pts / "
        f"{meta.n_real_obs} obs, k1={float(problem.cameras.dist[0,0]):.3f}"
    )

    config = BAConfig(maxiter=50, gtol=1e-10, cg_maxiter=30, cg_rtol=1e-6,
                      optimize_focal=False)
    solver = make_ba_solver(config)
    rmse0 = float(reprojection_rmse(problem, problem.cameras, problem.points3d))
    t0 = time.perf_counter()
    cams, pts, state = solver(problem)
    jax.block_until_ready(pts)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cams, pts, state = solver(problem)
    jax.block_until_ready(pts)
    solve_s = time.perf_counter() - t0
    rmse1 = float(reprojection_rmse(problem, cams, pts))
    print(
        f"solved on {jax.default_backend()}: RMSE {rmse0:.3f} -> {rmse1:.4f} px "
        f"in {int(state.accepted)}/{int(state.iter_num)} iters, "
        f"solve {solve_s:.2f}s (compile {compile_s:.1f}s)"
    )

    out = path.replace(".txt", "_solved.txt")
    export_bal(out, problem, cams, pts)
    re_problem, _ = ba_problem_from_bal(out, dtype=dtype)
    rmse_re = float(
        reprojection_rmse(re_problem, re_problem.cameras, re_problem.points3d)
    )
    print(f"exported + reloaded {out}: RMSE {rmse_re:.4f} px (round trip ok: "
          f"{abs(rmse_re - rmse1) < 1e-3})")


if __name__ == "__main__":
    main()
