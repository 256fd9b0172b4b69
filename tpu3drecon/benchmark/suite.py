"""The full BASELINE.md config ladder, driver-verifiable from one command.

``python bench.py --suite`` runs every config the reference harness defined
(reference: src/benchmark/jaxopt_benchmark/benchmark_pose_optimization.py:165-182
measured every scale it defined; BASELINE.md pins five) and prints ONE JSON
line per config, each with median/min/max error bars:

  1. pnp_parity      — batched PnP refinement vs an in-run scipy
                       ``least_squares`` oracle (pose parity + speedup)
  2. ba_small        — ~10 cams / 5k pts, reprojection RMSE vs the 1e-3 px
                       target
  3. ba_medium       — the plain-``bench.py`` headline (delegated, so the
                       suite line is config-identical to ``bench.py``'s)
  4. tracking_500    — 500-frame vmapped LM, one executable, ms/frame
  5. bal_lm_iter     — BAL-scale (1712 cams / 1M pts) wtt engine, s/LM-iter
                       (with ``--cpu`` this config runs at BAL-ratio scale
                       instead and says so in the JSON)

Every line names the device it ran on.  With no accelerator the suite
fails unless ``--cpu`` asks for the host on purpose.

Scales are parameterized only so tests can shrink them; the defaults ARE the
BASELINE.md configs.  All solves are fixed-work (fixed iteration counts) so
wall-clock comparisons measure identical work across backends and rounds.
"""

from __future__ import annotations

import json
import time
from typing import Callable, List, Tuple

import numpy as np


def _stats(times: List[float]) -> dict:
    ts = sorted(times)
    n = len(ts)
    med = ts[n // 2] if n % 2 else 0.5 * (ts[n // 2 - 1] + ts[n // 2])
    return {
        "median_s": round(med, 4),
        "min_s": round(ts[0], 4),
        "max_s": round(ts[-1], 4),
        "reps": n,
    }


def _timed(run: Callable, reps: int) -> Tuple[float, List[float], object]:
    """Compile/run split per the reference protocol (warm-up counted once)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(run())
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run())
        times.append(time.perf_counter() - t0)
    return compile_s, times, out


def run_pnp_parity(reps: int = 3, n_cameras: int = 8, n_points: int = 2300,
                   seed: int = 5) -> dict:
    """Config #1: single-image PnP refinement, ~2k matches per image.

    Parity oracle = scipy ``least_squares`` LM on the identical masked
    width-normalized residual, solved per camera in-run (the jaxopt-CPU
    stand-in, see adapters/scipy_adapter.py).  value = median batch solve
    time; parity errors (max over cameras vs the oracle's solution) ride in
    extra; vs_baseline = oracle wall / ours.
    """
    import jax
    import jax.numpy as jnp
    from scipy.optimize import least_squares
    from scipy.spatial.transform import Rotation

    from tpu3drecon.dataset.synthetic import (
        make_scene,
        perturb_scene,
        scene_to_pose_problem,
    )
    from tpu3drecon.geometry.losses import RobustLoss
    from tpu3drecon.solvers.lm_core import LMConfig
    from tpu3drecon.solvers.pose_refine import refine_poses

    scene = make_scene(
        n_cameras=n_cameras, n_points=n_points, obs_per_camera=n_points,
        seed=seed,
    )
    noisy = perturb_scene(
        scene, point3d_noise=0.0, camera_rotation_noise=1e-2,
        camera_translation_noise=3e-2, camera_intrinsics_noise=5.0,
        point2d_noise=0.0, seed=seed + 1,
    )
    problem, _ = scene_to_pose_problem(noisy, observed=scene)

    # xtol stops once steps collapse (lambda railing after the floor): the
    # accept-gated ftol never fires post-convergence (no strict decreases),
    # and a fixed 100-iteration run burns 5x the time railing lambda.
    config = LMConfig(maxiter=100, gtol=1e-10, ftol=1e-10, xtol=1e-8)
    compile_s, times, (cams, state) = _timed(
        lambda: refine_poses(problem, loss=RobustLoss.TRIVIAL, config=config),
        reps,
    )

    # In-run scipy oracle: identical residual (per-axis, trivial loss,
    # width-normalized), per camera.
    p3 = np.asarray(jax.device_get(problem.points3d))
    p2 = np.asarray(jax.device_get(problem.points2d))
    mask = np.asarray(jax.device_get(problem.mask))
    width = float(jax.device_get(problem.avg_cam_width))
    sol_r = np.zeros((n_cameras, 3))
    sol_t = np.zeros((n_cameras, 3))
    sol_f = np.zeros((n_cameras, 2))
    t0 = time.perf_counter()
    for c in range(n_cameras):
        m = mask[c] > 0
        xyz, uv = p3[c][m], p2[c][m]
        cx, cy, skew = np.asarray(noisy.cx_cy_skew[c])
        x0 = np.concatenate([
            Rotation.from_matrix(noisy.rmats[c]).as_rotvec(),
            noisy.tvecs[c], noisy.fx_fy[c],
        ])

        def residuals(p):
            rot = Rotation.from_rotvec(p[:3]).as_matrix()
            xc = xyz @ rot.T + p[3:6]
            xn = xc[:, :2] / xc[:, 2:3]
            proj = np.stack(
                [p[6] * xn[:, 0] + skew * xn[:, 1] + cx, p[7] * xn[:, 1] + cy],
                axis=1,
            )
            return ((proj - uv) / width).ravel()

        sol = least_squares(residuals, x0, method="lm", xtol=1e-15, ftol=1e-15)
        sol_r[c], sol_t[c], sol_f[c] = sol.x[:3], sol.x[3:6], sol.x[6:8]
    scipy_s = time.perf_counter() - t0

    # Rotation parity is geodesic (rotvec coordinates are ambiguous: theta
    # about v equals 2pi-theta about -v, and scipy may return either chart).
    # Small angles come from the skew part (sin-based): the arccos-of-trace
    # form is ill-conditioned at theta ~ 0 and saturates at the f32
    # representation floor (~5e-4 rad) no matter how exact the parity is.
    ours_R = np.asarray(jax.device_get(cams.rmats), np.float64)
    scipy_R = Rotation.from_rotvec(sol_r).as_matrix()
    rel = np.einsum("cji,cjk->cik", ours_R, scipy_R)
    skew = 0.5 * (rel - np.transpose(rel, (0, 2, 1)))
    s = np.sqrt(skew[:, 0, 1] ** 2 + skew[:, 0, 2] ** 2 + skew[:, 1, 2] ** 2)
    rot_err = float(np.max(np.arcsin(np.clip(s, 0.0, 1.0))))
    ours_t = np.asarray(jax.device_get(cams.tvecs))
    ours_f = np.asarray(jax.device_get(cams.fx_fy))
    t_err = float(np.max(np.abs(ours_t - sol_t)))
    f_err = float(np.max(np.abs(ours_f - sol_f)))

    st = _stats(times)
    return {
        "metric": "pnp_parity_batched_refine",
        "value": st["median_s"],
        "unit": "s",
        "vs_baseline": round(scipy_s / st["median_s"], 2),
        "extra": {
            **st,
            "compile_s": round(compile_s, 2),
            "n_cameras": n_cameras,
            "matches_per_image": int(mask.sum(axis=1).mean()),
            "scipy_oracle_s": round(scipy_s, 3),
            "max_rot_geodesic_err_vs_scipy_rad": float(f"{rot_err:.3e}"),
            "max_tvec_err_vs_scipy": float(f"{t_err:.3e}"),
            "max_focal_err_vs_scipy": float(f"{f_err:.3e}"),
            "parity_target": "f32 tolerance (BASELINE.md config #1)",
        },
    }


def run_small_ba(reps: int = 3, n_cameras: int = 10, n_points: int = 5000,
                 seed: int = 11) -> dict:
    """Config #2: small BA (~10 cams / 5k pts); value = reprojection RMSE px
    against the 1e-3 px target (BASELINE.md), time stats in extra."""
    import jax

    from tpu3drecon.dataset.synthetic import (
        make_scene,
        perturb_scene,
        scene_to_ba_problem,
    )
    from tpu3drecon.problems.tt import tt_from_flat
    from tpu3drecon.solvers.ba_tt import make_tt_ba_solver
    from tpu3drecon.solvers.bundle_adjust import BAConfig, reprojection_rmse
    from tpu3drecon.utils.placement import commit

    scene = make_scene(n_cameras=n_cameras, n_points=n_points, seed=seed)
    noisy = perturb_scene(scene, seed=seed + 1, point2d_noise=0.5)
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        flat, _ = scene_to_ba_problem(noisy, observed=scene)
        tt = tt_from_flat(flat)
    tt = commit(tt)
    flat_dev = commit(flat)
    config = BAConfig(
        maxiter=30, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=1e-4,
        precond="schur_jacobi",
    )
    solver = make_tt_ba_solver(config)
    compile_s, times, (cams, pts, state) = _timed(lambda: solver(tt), reps)
    rmse = float(jax.device_get(reprojection_rmse(flat_dev, cams, pts)))

    st = _stats(times)
    return {
        "metric": "ba_small_10cam_5kpt_rmse",
        "value": float(f"{rmse:.3e}"),
        "unit": "px",
        "vs_baseline": round(1e-3 / max(rmse, 1e-30), 1),
        "extra": {
            **st,
            "compile_s": round(compile_s, 2),
            "n_cameras": n_cameras,
            "n_points": n_points,
            "accepted_steps": int(jax.device_get(state.accepted)),
            "rmse_target_px": 1e-3,
            "baseline_desc": "BASELINE.md config #2: RMSE within 1e-3 px",
        },
    }


def run_tracking(reps: int = 2, n_frames: int = 500, n_obs: int = 1000,
                 seed: int = 81) -> dict:
    """Config #4: batched tracking — vmap LM over ``n_frames`` frames with
    shared intrinsics structure, ONE compiled executable.  value = ms/frame."""
    import jax

    from tpu3drecon.dataset.synthetic import (
        make_scene,
        perturb_scene,
        scene_to_pose_problem,
    )
    from tpu3drecon.solvers.lm_core import LMConfig
    from tpu3drecon.solvers.pose_refine import PoseRefiner, pose_params_pack

    scene = make_scene(
        n_cameras=n_frames, n_points=n_obs, obs_per_camera=n_obs, seed=seed
    )
    noisy = perturb_scene(
        scene, point3d_noise=0.0, camera_rotation_noise=1e-2,
        camera_translation_noise=3e-2, camera_intrinsics_noise=0.0,
        point2d_noise=0.0, seed=seed + 1,
    )
    problem, _ = scene_to_pose_problem(noisy, observed=scene)
    refiner = PoseRefiner(
        float(problem.avg_cam_width), config=LMConfig(maxiter=50, gtol=1e-12),
    )
    params0 = pose_params_pack(problem.cameras)

    compile_s, times, (params, state) = _timed(
        lambda: refiner.optimize(
            params0, problem.points3d, problem.points2d,
            problem.cameras.cx_cy_skew, problem.mask,
        ),
        reps,
    )
    t_err = float(np.median(np.abs(
        np.asarray(jax.device_get(params[:, 3:6])) - scene.tvecs
    )))

    st = _stats(times)
    ms_per_frame = st["median_s"] / n_frames * 1e3
    return {
        "metric": "tracking_500frame_ms_per_frame",
        "value": round(ms_per_frame, 3),
        "unit": "ms/frame",
        "extra": {
            **st,
            "compile_s": round(compile_s, 2),
            "n_frames": n_frames,
            "obs_per_frame": n_obs,
            "median_tvec_err": float(f"{t_err:.3e}"),
            "single_executable": True,
        },
    }


def run_bal(reps: int = 3, lm_iters: int = 3, full_scale: bool = True,
            ratio_cams: int = 128, ratio_ppc: int = 584) -> dict:
    """Config #5: BAL-scale wtt solve, s/LM-iter at fixed CG work.

    ``full_scale=False`` (the ``--cpu`` default) runs the same pipeline at
    BAL-ratio scale (``ratio_cams`` cameras) — the full problem needs an
    accelerator to finish in sensible time — and the JSON says so.
    """
    import jax

    from tpu3drecon.problems.wtt import expand_onehots
    from tpu3drecon.solvers.ba_wtt import make_wtt_ba_solver
    from tpu3drecon.solvers.bundle_adjust import BAConfig
    from tpu3drecon.utils.placement import commit

    if full_scale:
        from tpu3drecon.benchmark.balscale import bal_sequential_wtt

        problem = bal_sequential_wtt(verbose=False)
        n_cams, ppc = 1712, 584
    else:
        import jax.numpy as jnp

        from tpu3drecon.dataset.synthetic import (
            make_sequential_scene,
            perturb_scene,
            scene_to_ba_problem,
        )
        from tpu3drecon.problems.wtt import wtt_from_flat

        n_cams, ppc = ratio_cams, ratio_ppc
        with jax.default_device(jax.local_devices(backend="cpu")[0]):
            scene = make_sequential_scene(
                n_cameras=n_cams, points_per_camera=ppc, track_span=4, seed=7
            )
            noisy = perturb_scene(scene, seed=8, point2d_noise=0.5)
            flat, _ = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float32)
            problem = wtt_from_flat(flat, point_chunk=512, defer_onehot=True)

    # The compact problem crosses to the device; the dense one-hot is
    # expanded there (problems/wtt.expand_onehots).
    problem = expand_onehots(commit(problem))
    n_obs = int(sum(
        float(jax.device_get(b.mask.sum())) for b in problem.buckets
    ))
    # Fixed LM iterations, fixed 8-CG work.
    config = BAConfig(
        maxiter=lm_iters, gtol=0.0, ftol=0.0, cg_maxiter=8, cg_rtol=0.0,
        precond="schur_jacobi",
    )
    solver = make_wtt_ba_solver(config)
    compile_s, times, (cams, pts, state) = _timed(lambda: solver(problem), reps)

    st = _stats(times)
    s_per_iter = st["median_s"] / lm_iters
    # Marginal per-iteration rate: a 4x-iteration solve of the SAME
    # executable (maxiter is a dynamic operand) minus the headline run,
    # divided by the extra iterations — it leaves out the per-solve
    # linearization/initial-cost work that wall/maxiter folds in.
    solver4 = make_wtt_ba_solver(config._replace(maxiter=4 * lm_iters))
    _, times4, _ = _timed(lambda: solver4(problem), max(2, reps - 1))
    marginal = (sorted(times4)[len(times4) // 2] - st["median_s"]) / (
        3 * lm_iters
    )
    return {
        "metric": "bal_wtt_s_per_lm_iter",
        "value": round(s_per_iter, 4),
        "unit": "s/LM-iter",
        "extra": {
            **st,
            "marginal_s_per_lm_iter": round(marginal, 4),
            "compile_s": round(compile_s, 2),
            "n_cameras": n_cams,
            "points_per_camera": ppc,
            "n_obs": n_obs,
            "lm_iters": lm_iters,
            "cg_maxiter": 8,
            "full_scale": full_scale,
            "accepted_steps": int(jax.device_get(state.accepted)),
            "loss": float(f"{float(jax.device_get(state.loss)):.4e}"),
        },
    }


def run_suite(force_cpu: bool = False, cg: int | None = None,
              engine: str | None = None) -> None:
    """Run all five BASELINE.md configs; one JSON line each, each naming
    the device.  Medium BA is delegated to ``bench.emit_headline`` so the
    suite's headline line is config-identical to plain ``python bench.py``.
    Refuses the CPU unless ``force_cpu`` asks for it."""
    import jax

    from tpu3drecon.utils.device import device_info, require_accelerator

    if force_cpu:
        jax.config.update("jax_platforms", "cpu")
        info = device_info()
    else:
        info = require_accelerator(what="bench.py --suite")
    device = info.as_dict()

    def emit(line: dict) -> None:
        print(json.dumps({**line, "device": device}))

    emit(run_pnp_parity())
    emit(run_small_ba())

    import bench

    bench.emit_headline(
        force_cpu=force_cpu, cg=cg, engine=engine or bench.DEFAULT_ENGINE
    )
    emit(run_tracking(reps=2 if force_cpu else 3))
    emit(run_bal(full_scale=not force_cpu))
