"""Smoke check on the accelerator: the main path, through the entry points a
user calls, at the medium config's full size, checked against plain
references.

    python chip_smoke.py           # one card: device, medium BA on all four
                                   # engines, pose refinement, the CLI
    python chip_smoke.py --four    # only the sharded engines on a 4-card
                                   # mesh, each against its one-card solve

Each phase prints one JSON line; any phase that fails its check makes the
script exit non-zero.  The last line of a passing run is exactly
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
With no GPU the script exits non-zero before any phase runs.

References and tolerances:

- medium BA: each engine in f32 on the card against the flat engine in f64
  on the host CPU device of this process, same problem, same iterations.
  The solvers pin ``jax.default_matmul_precision("highest")``, which on
  the GPU means true f32 (no TF32).  Segment sums use atomics on the GPU, so
  summation order changes from run to run and no bit equality is asked.
  Checked: final RMSE <= 1e-3 px (the BASELINE target) for both; the
  initial cost within 1e-5 relative (the residual function, to f32
  rounding); the cost after one LM iteration within 1e-2 relative (that
  step cuts the cost ~3000x, so f32 rounding of its inexact CG solve shows
  up amplified: 6e-4 at most on the CPU test scene).  Later iterations
  approach the f32 noise floor and are not compared.
- pose: batched PnP against the in-run scipy ``least_squares`` oracle at
  the f32 parity bars of tests/test_suite.py; 500-frame tracking in one
  executable, median translation error against ground truth.
- cli: ``python -m tpu3drecon solve-bal`` in-process on a seeded
  Ladybug-49-shaped BAL file; the exported solution, reloaded, must
  reproduce the RMSE the CLI reported (BAL text precision).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpu3drecon.benchmark import medium_config as mc  # noqa: E402
from tpu3drecon.utils.device import (  # noqa: E402
    device_info,
    nvidia_smi_name_and_power_limit,
    peak_bytes_in_use,
)

RMSE_TARGET_PX = 1e-3
# LM iterations after which the cost is compared, and the relative
# tolerance for each (see the module docstring).
COST_CHECKS = {0: 1e-5, 1: 1e-2}
PNP_ROT_TOL_RAD = 1e-4
PNP_TVEC_TOL = 2e-3
TRACK_TVEC_TOL = 1e-3
CLI_RMSE_TOL_PX = 1e-3


class PhaseFailed(RuntimeError):
    pass


def _emit(phase: str, **fields) -> dict:
    line = {"phase": phase, **fields}
    print(json.dumps(line), flush=True)
    return line


def _check(cond: bool, phase: str, msg: str) -> None:
    if not cond:
        raise PhaseFailed(f"{phase}: {msg}")


def _median(ts):
    return float(np.median(np.asarray(ts)))


def phase_device() -> dict:
    """Device report: JAX's view, the card's name and power limit, the
    compile settings in effect."""
    from tpu3drecon.utils.compile_cache import cache_dir, enable_compilation_cache

    enable_compilation_cache()
    info = device_info()
    smi = nvidia_smi_name_and_power_limit()
    if smi is not None:
        print(smi, flush=True)
    return _emit(
        "device",
        **info.as_dict(),
        nvidia_smi=smi,
        jax_version=jax.__version__,
        xla_flags=os.environ.get("XLA_FLAGS", ""),
        compile_cache_dir=str(cache_dir()),
    )


def _reference_flat_f64(n_cameras, n_points, obs_per_camera, config):
    """The plain reference: flat engine, f64, on the host CPU device."""
    from tpu3drecon.solvers.bundle_adjust import make_ba_solver, reprojection_rmse

    cpu = jax.local_devices(backend="cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        flat = mc.build_problem(
            jnp.float64, on_host=True, n_cameras=n_cameras, n_points=n_points,
            obs_per_camera=obs_per_camera,
        )
        t0 = time.perf_counter()
        cams, pts, state = jax.block_until_ready(make_ba_solver(config)(flat))
        ref_s = time.perf_counter() - t0
        rmse = float(reprojection_rmse(flat, cams, pts))
        costs = _early_costs(lambda c: make_ba_solver(c)(flat), config)
        return {
            "rmse_px": rmse,
            "cost": float(state.loss),
            "early_costs": costs,
            "accepted_steps": int(state.accepted),
            "seconds_incl_compile": ref_s,
        }


def _early_costs(solve, config) -> dict:
    """Cost after each of the COST_CHECKS iteration counts; ``solve(cfg)``
    runs one solve (maxiter is a dynamic operand: no recompile)."""
    return {
        k: float(solve(config._replace(maxiter=k))[2].loss)
        for k in COST_CHECKS
    }


def _cost_diffs(costs: dict, ref: dict) -> dict:
    return {
        k: abs(costs[k] - ref[k]) / max(abs(ref[k]), 1e-30) for k in costs
    }


def _check_costs(phase: str, engine: str, diffs: dict) -> None:
    for k, tol in COST_CHECKS.items():
        _check(diffs[k] <= tol, phase,
               f"{engine} cost after {k} LM iters: rel diff {diffs[k]} > {tol}")


def phase_medium_ba(engines=mc.ENGINES, reps: int = 3,
                    n_cameras: int = mc.N_CAMERAS, n_points: int = mc.N_POINTS,
                    obs_per_camera: int = mc.OBS_PER_CAMERA,
                    config=mc.BENCH_CONFIG) -> list:
    """Every engine in f32 on the default device against the f64 flat
    reference on the host CPU."""
    from tpu3drecon.solvers.bundle_adjust import reprojection_rmse
    from tpu3drecon.utils.placement import commit

    ref = _reference_flat_f64(n_cameras, n_points, obs_per_camera, config)
    _emit("medium_ba_reference", engine="flat", dtype="float64",
          device="cpu", lm_iters=config.maxiter, **ref)
    flat_host = mc.build_problem(
        on_host=True, n_cameras=n_cameras, n_points=n_points,
        obs_per_camera=obs_per_camera,
    )
    flat_dev = commit(flat_host)
    lines = []
    for engine in engines:
        solver, problem = mc.prepare_engine(engine, config, flat_host)
        compile_s, times, (cams, pts, state) = mc.timed_solve_stats(
            solver, problem, repeats=reps
        )
        rmse = float(reprojection_rmse(flat_dev, cams, pts))
        costs = _early_costs(
            lambda c: mc.engine_solver(engine, c)(problem), config
        )
        diffs = _cost_diffs(costs, ref["early_costs"])
        line = _emit(
            "medium_ba", engine=engine, dtype="float32",
            matmul_precision="highest (true f32, no TF32)",
            lm_iters=config.maxiter, cg_maxiter=config.cg_maxiter,
            compile_s=compile_s, median_s=_median(times), min_s=min(times),
            max_s=max(times), reps=len(times), rmse_px=rmse,
            accepted_steps=int(state.accepted),
            peak_bytes_in_use_so_far=peak_bytes_in_use(),
            early_costs=costs, early_cost_rel_diff_vs_f64=diffs,
            tolerance=(
                f"rmse <= {RMSE_TARGET_PX} px (BASELINE target); cost after "
                f"k LM iters within {COST_CHECKS} (k: relative tol) of the "
                "f64 CPU flat reference (f32 rounding + atomic summation "
                "order)"
            ),
        )
        _check(np.isfinite(rmse) and rmse <= RMSE_TARGET_PX, "medium_ba",
               f"{engine} rmse {rmse} > {RMSE_TARGET_PX}")
        _check_costs("medium_ba", engine, diffs)
        lines.append(line)
    _check(ref["rmse_px"] <= RMSE_TARGET_PX, "medium_ba",
           f"f64 reference rmse {ref['rmse_px']} > {RMSE_TARGET_PX}")
    return lines


def phase_pose(pnp_kwargs=None, tracking_kwargs=None) -> list:
    """Batched PnP vs the scipy oracle; 500-frame tracking."""
    from tpu3drecon.benchmark import suite

    pnp = suite.run_pnp_parity(**(pnp_kwargs or {}))
    ex = pnp["extra"]
    a = _emit("pose_pnp", **pnp, tolerance=(
        f"rot <= {PNP_ROT_TOL_RAD} rad, tvec <= {PNP_TVEC_TOL} vs scipy "
        "(f32 parity)"))
    _check(ex["max_rot_geodesic_err_vs_scipy_rad"] <= PNP_ROT_TOL_RAD, "pose",
           f"PnP rotation parity {ex['max_rot_geodesic_err_vs_scipy_rad']}")
    _check(ex["max_tvec_err_vs_scipy"] <= PNP_TVEC_TOL, "pose",
           f"PnP translation parity {ex['max_tvec_err_vs_scipy']}")
    trk = suite.run_tracking(**(tracking_kwargs or {}))
    b = _emit("pose_tracking", **trk,
              tolerance=f"median tvec err <= {TRACK_TVEC_TOL}")
    _check(trk["extra"]["median_tvec_err"] <= TRACK_TVEC_TOL, "pose",
           f"tracking tvec err {trk['extra']['median_tvec_err']}")
    return [a, b]


_RMSE_RE = re.compile(r"RMSE ([0-9.eE+-]+) -> ([0-9.eE+-]+) px")


def phase_cli(workdir: str, bal_writer=None,
              extra_args=("--no-focal",)) -> dict:
    """``solve-bal`` in-process on a seeded BAL file, then export -> reload
    -> same RMSE.  ``--no-focal`` by default: a BAL camera has ONE focal
    length, so a solve that refines fx and fy apart cannot round-trip
    through the file."""
    from tpu3drecon import cli
    from tpu3drecon.io.bal import ba_problem_from_bal
    from tpu3drecon.solvers.bundle_adjust import reprojection_rmse

    if bal_writer is None:
        from examples.bal_pipeline import make_ladybug49_like as bal_writer
    src = os.path.join(workdir, "seeded.txt")
    out = os.path.join(workdir, "solved.txt")
    with contextlib.redirect_stdout(sys.stderr):
        bal_writer(src)
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["solve-bal", src, "-o", out, *extra_args])
    wall = time.perf_counter() - t0
    log = err.getvalue()
    sys.stderr.write(log)
    _check(rc == 0, "cli", f"solve-bal exited {rc}")
    m = _RMSE_RE.search(log)
    _check(m is not None, "cli", "solve-bal printed no RMSE line")
    rmse0, rmse1 = float(m.group(1)), float(m.group(2))
    reloaded, _ = ba_problem_from_bal(out)
    rmse_re = float(
        reprojection_rmse(reloaded, reloaded.cameras, reloaded.points3d)
    )
    line = _emit(
        "cli", command="solve-bal", args=list(extra_args), wall_s=wall,
        rmse_before_px=rmse0, rmse_after_px=rmse1, rmse_reloaded_px=rmse_re,
        tolerance=f"|reloaded - reported| <= {CLI_RMSE_TOL_PX} px",
    )
    _check(rmse1 < rmse0, "cli", f"RMSE did not improve ({rmse0} -> {rmse1})")
    _check(abs(rmse_re - rmse1) <= CLI_RMSE_TOL_PX, "cli",
           f"reloaded RMSE {rmse_re} != reported {rmse1}")
    return line


def _sharded_solvers(mesh, flat_host):
    """(engine, solve, placed observation array) triples: each solve runs
    the sharded engine on the mesh from host-packed inputs (placement
    included); the array is that engine's largest observation array as its
    placement puts it on the mesh."""
    from tpu3drecon.parallel.mesh import shard_ba_problem
    from tpu3drecon.parallel.sharded_ba import make_sharded_ba_solver
    from tpu3drecon.parallel.sharded_grid import (
        ba_solve_grid_sharded,
        shard_grid_problem,
    )
    from tpu3drecon.parallel.sharded_tt import ba_solve_tt_sharded, shard_tt_problem
    from tpu3drecon.parallel.sharded_wtt import (
        ba_solve_wtt_sharded,
        shard_wtt_problem,
    )
    from tpu3drecon.problems.grid import grid_bucketed_from_flat
    from tpu3drecon.problems.tt import tt_from_flat
    from tpu3drecon.problems.wtt import wtt_from_flat

    n = mesh.devices.size
    axis = mesh.axis_names[0]
    placed = shard_ba_problem(flat_host, mesh, axis)
    grid = grid_bucketed_from_flat(flat_host)
    tt = tt_from_flat(flat_host)
    wtt = wtt_from_flat(flat_host, chunk_multiple=n)
    return [
        ("flat", lambda c: make_sharded_ba_solver(mesh, c, axis)(placed),
         placed.uv),
        ("grid", lambda c: ba_solve_grid_sharded(grid, c, mesh=mesh),
         shard_grid_problem(grid, mesh, axis).uv),
        ("tt", lambda c: ba_solve_tt_sharded(tt, c, mesh=mesh),
         shard_tt_problem(tt, mesh, axis)[0][0].uv),
        ("wtt", lambda c: ba_solve_wtt_sharded(wtt, c, mesh=mesh),
         shard_wtt_problem(wtt, mesh, axis)[0][0].uv),
    ]


def _shard_layout(x) -> dict:
    """Which devices hold which slice of a placed array."""
    shards = x.addressable_shards
    return {
        "global_shape": list(x.shape),
        "device_ids": sorted({s.device.id for s in shards}),
        "shard_shapes": sorted({tuple(s.data.shape) for s in shards}),
    }


def phase_sharded(n_devices: int = 4, reps: int = 3,
                  n_cameras: int = mc.N_CAMERAS, n_points: int = mc.N_POINTS,
                  obs_per_camera: int = mc.OBS_PER_CAMERA,
                  config=mc.BENCH_CONFIG) -> list:
    """Each sharded engine on a 1-D mesh over ``n_devices`` against the
    same engine's one-card solve."""
    from tpu3drecon.parallel.mesh import make_mesh
    from tpu3drecon.solvers.bundle_adjust import reprojection_rmse
    from tpu3drecon.utils.placement import commit

    devs = jax.devices()
    _check(len(devs) >= n_devices, "sharded",
           f"need {n_devices} devices, have {len(devs)}")
    mesh = make_mesh(n_devices)
    flat_host = mc.build_problem(
        on_host=True, n_cameras=n_cameras, n_points=n_points,
        obs_per_camera=obs_per_camera,
    )
    flat_dev = commit(flat_host)
    lines = []
    for engine, solve, placed_obs in _sharded_solvers(mesh, flat_host):
        layout = _shard_layout(placed_obs)
        one_solver, one_problem = mc.prepare_engine(engine, config, flat_host)
        _, one_times, (c1, p1, s1) = mc.timed_solve_stats(
            one_solver, one_problem, repeats=reps
        )
        one_rmse = float(reprojection_rmse(flat_dev, c1, p1))
        one_costs = _early_costs(
            lambda c: mc.engine_solver(engine, c)(one_problem), config
        )

        compile_s, times, (cs, ps, ss) = mc.timed_solve_stats(
            lambda _: solve(config), None, repeats=reps
        )
        shard_rmse = float(reprojection_rmse(flat_dev, commit(cs), commit(ps)))
        costs = _early_costs(solve, config)
        diffs = _cost_diffs(costs, one_costs)
        line = _emit(
            "sharded_ba", engine=engine, mesh_devices=n_devices,
            placed_observations=layout, compile_s=compile_s,
            median_s_incl_placement=_median(times), min_s=min(times),
            max_s=max(times), reps=len(times), rmse_px=shard_rmse,
            accepted_steps=int(ss.accepted),
            one_card_median_s=_median(one_times), one_card_rmse_px=one_rmse,
            one_card_accepted_steps=int(s1.accepted),
            early_costs=costs, one_card_early_costs=one_costs,
            early_cost_rel_diff=diffs,
            tolerance=(
                f"rmse <= {RMSE_TARGET_PX} px; cost after k LM iters within "
                f"{COST_CHECKS} (k: relative tol) of the one-card solve "
                "(psum summation order)"
            ),
        )
        _check(shard_rmse <= RMSE_TARGET_PX, "sharded",
               f"{engine} rmse {shard_rmse}")
        _check_costs("sharded", engine, diffs)
        _check(
            len(layout["device_ids"]) == n_devices
            and all(list(sh) != layout["global_shape"]
                    for sh in layout["shard_shapes"]),
            "sharded", f"{engine} observations not split over the mesh: "
            f"{layout}",
        )
        lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded engines on a 4-card mesh, "
                    "each against its one-card solve")
    args = ap.parse_args(argv)

    info = device_info()
    if info.platform != "gpu":
        print(
            f"chip_smoke: needs a GPU; JAX found platform {info.platform!r} "
            f"({info.count} device(s))", file=sys.stderr,
        )
        return 1
    t0 = time.perf_counter()
    try:
        phase_device()
        if args.four:
            phase_sharded(n_devices=4)
        else:
            phase_medium_ba()
            phase_pose()
            scratch = REPO / "chiprun_out"
            scratch.mkdir(exist_ok=True)
            with tempfile.TemporaryDirectory(dir=scratch) as d:
                phase_cli(d)
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    print(json.dumps({"ok": True, "device": {
        "platform": info.platform, "kind": info.device_kind,
        "count": info.count,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
