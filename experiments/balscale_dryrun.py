"""BAL-class scale proof (BASELINE config #5: ~1.7k cams / 1M points).

Modes:
  python experiments/balscale_dryrun.py cpu8   # 8-device virtual CPU mesh,
      sharded bucketed-grid engine, 1 LM iteration (compile + execute proof)
  python experiments/balscale_dryrun.py wtt [precond|fixedcg]  # one
      accelerator, windowed track-table engine on a SEQUENTIAL-capture scene
      (the layout that models real BAL trajectories), 3 LM iterations
  python experiments/balscale_dryrun.py wtt_shuffled  # the same scene with
      camera ids shuffled (RCM relabeling must recover the windows)
  python experiments/balscale_dryrun.py cpu8_wtt  # 8-device virtual CPU
      mesh, SHARDED windowed track-table engine at full BAL scale

Must be the process's FIRST jax use (platform/device-count switching).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json
import sys
import time


def build_problem():
    import jax.numpy as jnp

    from tpu3drecon.dataset.synthetic import make_scene, perturb_scene, scene_to_ba_problem
    from tpu3drecon.problems.grid import grid_bucketed_from_flat

    t0 = time.time()
    scene = make_scene(
        n_cameras=1712, n_points=1_000_000, obs_per_camera=2400, seed=7,
        ring_radius=14.0, cloud_radius=6.0,
    )
    noisy = perturb_scene(scene, seed=8, point2d_noise=0.5)
    flat, _ = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float32)
    grid = grid_bucketed_from_flat(flat)
    n_obs = int(sum(float(b.track_mask.sum()) for b in grid.buckets))
    print(
        f"built BAL-class problem in {time.time()-t0:.0f}s: "
        f"{grid.n_cameras} cams x K={grid.uv.shape[1]}, "
        f"{grid.points3d.shape[0]} padded points "
        f"({grid.n_real_points} real), {n_obs} obs, "
        f"buckets={[tuple(b.track_idx.shape) for b in grid.buckets]}",
        flush=True,
    )
    return grid


def main_cpu8():
    import os

    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    assert len(jax.devices()) == 8, jax.devices()

    from tpu3drecon.parallel.mesh import make_mesh
    from tpu3drecon.parallel.sharded_grid import ba_solve_grid_sharded
    from tpu3drecon.solvers.bundle_adjust import BAConfig

    grid = build_problem()
    mesh = make_mesh(8)
    config = BAConfig(maxiter=1, gtol=0.0, ftol=0.0, cg_maxiter=2, cg_rtol=1e-6)
    t0 = time.time()
    cams, pts, state = ba_solve_grid_sharded(grid, config, mesh=mesh)
    jax.block_until_ready(pts)
    total = time.time() - t0
    loss = float(jax.device_get(state.loss))
    print(json.dumps({
        "mode": "cpu8_sharded_grid", "cams": int(grid.n_cameras),
        "points": int(grid.n_real_points),
        "lm_iters": 1, "compile_plus_run_s": round(total, 1),
        "loss": loss, "finite": loss == loss,
        "accepted": int(jax.device_get(state.accepted)),
    }), flush=True)


def main_cpu8_wtt():
    import os

    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    assert len(jax.devices()) == 8, jax.devices()
    from tpu3drecon.benchmark.balscale import bal_sequential_wtt
    from tpu3drecon.parallel.mesh import make_mesh
    from tpu3drecon.parallel.sharded_wtt import ba_solve_wtt_sharded
    from tpu3drecon.problems.wtt import expand_onehots
    from tpu3drecon.solvers.bundle_adjust import BAConfig

    t0 = time.time()
    wtt = expand_onehots(bal_sequential_wtt(chunk_multiple=8))
    print(
        f"built sequential BAL-class problem in {time.time()-t0:.0f}s: "
        f"{wtt.n_cameras} cams, {wtt.n_real_points} pts, groups="
        f"{[b.uv.shape[0] for b in wtt.buckets]}",
        flush=True,
    )
    mesh = make_mesh(8)
    config = BAConfig(maxiter=1, gtol=0.0, ftol=0.0, cg_maxiter=2, cg_rtol=1e-6)
    t0 = time.time()
    cams, pts, state = ba_solve_wtt_sharded(wtt, config, mesh=mesh)
    jax.block_until_ready(pts)
    total = time.time() - t0
    loss = float(jax.device_get(state.loss))
    print(json.dumps({
        "mode": "cpu8_sharded_wtt", "cams": int(wtt.n_cameras),
        "points": int(wtt.n_real_points),
        "lm_iters": 1, "compile_plus_run_s": round(total, 1),
        "loss": loss, "finite": loss == loss,
        "accepted": int(jax.device_get(state.accepted)),
    }), flush=True)


def main_wtt(shuffled: bool = False):
    import jax

    from tpu3drecon.solvers.ba_wtt import make_wtt_ba_solver
    from tpu3drecon.solvers.bundle_adjust import BAConfig
    from tpu3drecon.utils.compile_cache import enable_compilation_cache
    from tpu3drecon.utils.device import device_info, require_accelerator

    require_accelerator(what="balscale_dryrun wtt")
    enable_compilation_cache()

    from tpu3drecon.benchmark.balscale import bal_sequential_wtt

    t0 = time.time()
    wtt = bal_sequential_wtt(shuffled=shuffled)
    if shuffled:
        assert wtt.cam_rows is not None, "RCM relabeling did not trigger"
    n_obs = int(sum(float(b.mask.sum()) for b in wtt.buckets))
    shapes = [
        (tuple(b.uv.shape), int(b.window)) for b in wtt.buckets
    ]
    compact_mb = sum(
        b.wcam.size * b.wcam.dtype.itemsize for b in wtt.buckets
    ) / 1e6
    build_s = time.time() - t0
    print(
        f"built sequential BAL-class problem in {build_s:.0f}s: "
        f"{wtt.n_cameras} cams (c_pad {wtt.c_pad}), "
        f"{wtt.n_real_points} real points, {n_obs} obs, "
        f"buckets (uv shape, window)={shapes}, "
        f"compact one-hots {compact_mb:.0f} MB",
        flush=True,
    )
    from tpu3drecon.problems.wtt import expand_onehots
    from tpu3drecon.utils.placement import commit

    t0 = time.time()
    wtt = commit(wtt)
    jax.block_until_ready(wtt.buckets[0].uv)
    transfer_s = time.time() - t0
    t0 = time.time()
    wtt = expand_onehots(wtt)
    jax.block_until_ready(wtt.buckets[-1].onehot)
    expand_s = time.time() - t0
    onehot_gb = sum(
        b.onehot.size * b.onehot.dtype.itemsize for b in wtt.buckets
    ) / 1e9
    print(
        f"transfer {transfer_s:.1f}s, device one-hot expansion {expand_s:.1f}s "
        f"({onehot_gb:.2f} GB resident)",
        flush=True,
    )

    if len(sys.argv) > 2 and sys.argv[2] == "precond":
        # Interleaved A/B (VERDICT #4): schur_jacobi vs block-tridiagonal
        # preconditioner at BAL scale on sequential data, equal-work solves.
        outs = {}
        for name in ("schur_jacobi", "tridiag", "ssor"):
            # CG to TOLERANCE (not a fixed budget) so preconditioner
            # quality shows up as wall time + iteration count.
            cfg = BAConfig(maxiter=3, gtol=0.0, ftol=0.0, cg_maxiter=30,
                           cg_rtol=1e-6, precond=name)
            solver = make_wtt_ba_solver(cfg)
            t0 = time.time()
            jax.block_until_ready(solver(wtt))
            print(f"{name}: compile {time.time()-t0:.1f}s", flush=True)
            outs[name] = solver
        times = {name: [] for name in outs}
        final = {}
        for _ in range(4):
            for name, solver in outs.items():
                t0 = time.time()
                out = jax.block_until_ready(solver(wtt))
                times[name].append(time.time() - t0)
                final[name] = out
        for name in outs:
            ts = sorted(times[name])
            st = final[name][2]
            print(json.dumps({
                "mode": "wtt_precond", "precond": name,
                "best_s": round(ts[0], 3), "median_s": round(ts[len(ts)//2], 3),
                "s_per_lm_iter": round(ts[0] / 3, 3),
                "loss": float(jax.device_get(st.loss)),
                "cg_iters": int(jax.device_get(st.cg_iters)),
                "accepted": int(jax.device_get(st.accepted)),
            }), flush=True)
        return

    # "fixedcg" mode: cg_rtol=0 forces exactly cg_maxiter CG iterations per
    # LM step — a trajectory-independent s/LM-iter (the default early-exit
    # rtol makes runtime depend on how hard each step's linear system is,
    # which shifts with f32 accumulation-order changes between code
    # versions).
    fixed = len(sys.argv) > 2 and sys.argv[2] == "fixedcg"
    config = BAConfig(
        maxiter=3, gtol=0.0, ftol=0.0, cg_maxiter=8,
        cg_rtol=0.0 if fixed else 1e-4,
    )
    solver = make_wtt_ba_solver(config)
    t0 = time.time()
    jax.block_until_ready(solver(wtt))
    compile_s = time.time() - t0
    t0 = time.time()
    cams, pts, state = jax.block_until_ready(solver(wtt))
    run_s = time.time() - t0
    loss = float(state.loss)
    print(json.dumps({
        "mode": "wtt_shuffled" if shuffled else "wtt_single_device",
        "device": device_info().as_dict(),
        "fixed_cg": fixed, "cams": int(wtt.n_cameras),
        "points": int(wtt.n_real_points), "obs": n_obs, "lm_iters": 3,
        "build_s": round(build_s, 1), "transfer_s": round(transfer_s, 1),
        "expand_s": round(expand_s, 1),
        "compile_s": round(compile_s, 1), "run_s": round(run_s, 2),
        "s_per_lm_iter": round(run_s / 3, 3),
        "loss": loss, "finite": loss == loss,
        "accepted": int(jax.device_get(state.accepted)),
    }), flush=True)


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "cpu8"
    if mode == "cpu8":
        main_cpu8()
    elif mode == "cpu8_wtt":
        main_cpu8_wtt()
    elif mode == "wtt":
        main_wtt()
    elif mode == "wtt_shuffled":
        main_wtt(shuffled=True)
    else:
        raise SystemExit(f"unknown mode {mode!r}")
