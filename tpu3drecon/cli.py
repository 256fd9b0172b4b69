"""Command-line interface: solve / refine / bench / info.

The production entry point around the library (the reference drives
everything from notebooks; a deployable framework needs a CLI):

    python -m tpu3drecon info
    python -m tpu3drecon solve-bal problem.txt [-o solved.txt] [--engine tt]
    python -m tpu3drecon solve-colmap sparse/ -o sparse_opt/ [--binary]
    python -m tpu3drecon bench [--cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

ENGINES = ("flat", "grid", "tt", "wtt")


def _split_windows_arg(value: str):
    """``--split-windows`` value: auto/on/off or a positive int class cap."""
    if value in ("auto", "on", "off"):
        return value
    try:
        cap = int(value)
    except ValueError:
        cap = 0
    if cap <= 0:
        raise argparse.ArgumentTypeError(
            f"expected auto, on, off, or a positive integer class cap "
            f"(got {value!r})"
        )
    return cap


def _add_common(p):
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    p.add_argument("--f64", action="store_true", help="solve in float64")
    p.add_argument("--maxiter", type=int, default=50)
    p.add_argument("--cg-maxiter", type=int, default=30)
    p.add_argument(
        "--engine", choices=ENGINES, default="flat",
        help="BA engine (flat = segment-sum implicit Schur; grid = "
        "scatter-free grid; tt = gather-free track table; wtt = windowed "
        "track table for BAL-scale camera counts on sequential captures)",
    )
    p.add_argument("--no-focal", action="store_true", help="freeze focal lengths")
    p.add_argument("--loss", choices=("trivial", "cauchy"), default="trivial")
    p.add_argument(
        "--precond",
        choices=("auto", "schur_jacobi", "ssor", "tridiag", "jacobi_u"),
        default="auto",
        help="CG preconditioner for the reduced camera system.  auto "
        "picks block-SSOR for track-table engines at >=1000 cameras "
        "(fewer CG iterations on large sequential scenes, RESULTS.md) and "
        "SCHUR_JACOBI otherwise",
    )
    p.add_argument(
        "--split-windows", type=_split_windows_arg, default="auto",
        metavar="{auto,on,off,N}",
        help="micro-chunk window classes for the wtt packer "
        "(problems/wtt.py split_windows): narrower per-chunk windows cut "
        "the one-hot selection MACs at the cost of more, smaller batches "
        "and more buckets to compile.  auto = off (the XLA einsum paths "
        "prefer few large batches).  An integer N > 0 sets the "
        "per-bucket window-class cap directly ('on' = 4)",
    )
    p.add_argument(
        "--checkpoint-dir", default=None,
        help="run the solve as resumable chunks with orbax checkpoints in "
        "this directory; a killed run re-invoked with the same directory "
        "resumes from the last completed chunk (utils/checkpoint.py)",
    )
    p.add_argument(
        "--checkpoint-every", type=int, default=10, metavar="N",
        help="outer LM iterations per checkpoint chunk (default 10)",
    )


def _setup_backend(args):
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if getattr(args, "f64", False):
        # Without this a fresh process would silently downcast the f64
        # problem arrays to f32 (tests run under conftest's global x64).
        jax.config.update("jax_enable_x64", True)
    from tpu3drecon.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    return jax


def _config(args, n_cameras: int = 0):
    from tpu3drecon.geometry.losses import RobustLoss
    from tpu3drecon.solvers.bundle_adjust import BAConfig

    precond = getattr(args, "precond", "auto")
    if precond in ("ssor", "tridiag") and args.engine not in ("tt", "wtt"):
        print(
            f"[tpu3drecon] --precond {precond} requires --engine tt or wtt "
            "(band preconditioners need the track-table pair one-hots)",
            file=sys.stderr,
        )
        raise SystemExit(2)
    if precond == "auto":
        # The band information cuts CG iterations at BAL-scale camera
        # counts and did not pay at 100-256 cams (RESULTS.md; the
        # threshold is not yet re-measured on the H100); band
        # preconditioners exist for the tt/wtt engines.
        if args.engine in ("tt", "wtt") and n_cameras >= 1000:
            precond = "ssor"
        else:
            precond = "schur_jacobi"
    sw = getattr(args, "split_windows", "auto")
    if sw != "auto" and args.engine != "wtt":
        print(
            f"[tpu3drecon] --split-windows {sw} applies to --engine wtt "
            "only (micro-chunk window classes are a wtt packing concept)",
            file=sys.stderr,
        )
        raise SystemExit(2)
    return BAConfig(
        maxiter=args.maxiter,
        cg_maxiter=args.cg_maxiter,
        gtol=1e-10,
        cg_rtol=1e-6,
        optimize_focal=not args.no_focal,
        loss=RobustLoss.CAUCHY if args.loss == "cauchy" else RobustLoss.TRIVIAL,
        precond=precond,
    )


def _solve(problem, args, jax):
    import jax.numpy as jnp

    from tpu3drecon.solvers.bundle_adjust import make_ba_solver, reprojection_rmse

    config = _config(args, n_cameras=int(problem.n_cameras))
    rmse0 = float(reprojection_rmse(problem, problem.cameras, problem.points3d))
    # Each engine branch yields (packed problem, solver factory by config);
    # the factories cache compiled executables by config, and iteration
    # bounds ride as dynamic operands — so the checkpointed chunked driver
    # below reuses ONE executable across chunks.
    if args.engine == "wtt":
        from tpu3drecon.problems.wtt import wtt_from_flat
        from tpu3drecon.solvers.ba_wtt import make_wtt_ba_solver

        from tpu3drecon.utils.placement import commit

        sw = getattr(args, "split_windows", "auto")
        if sw == "auto":
            split = False
        elif isinstance(sw, int):
            split = sw  # explicit per-bucket window-class cap
        else:
            split = sw == "on"
        try:
            packed = commit(wtt_from_flat(problem, split_windows=split))
        except ValueError as e:
            # Dislocal scene beyond even the hub/global split: the camera
            # windows exceed the one-hot memory budget.  Fall back to the
            # layout-agnostic grid engine rather than dying.
            fallback = "grid"
            precond_note = ""
            if config.precond in ("ssor", "tridiag"):
                # Band preconditioners are tt/wtt-only (they need the
                # track-table pair one-hots).
                precond_note = (
                    f"; band preconditioner {config.precond!r} replaced "
                    "with schur_jacobi (ssor/tridiag are tt/wtt-only)"
                )
                config = config._replace(precond="schur_jacobi")
            print(
                f"[tpu3drecon] wtt layout infeasible ({e}); "
                f"falling back to the {fallback} engine{precond_note}",
                file=sys.stderr,
            )
            args.engine = fallback  # the summary line reports reality
        else:
            if config.precond in ("ssor", "tridiag") and any(
                b.global_tiles for b in packed.buckets
            ):
                # Hub/global split layout (dislocal scene): the band
                # preconditioners' pair one-hots don't cover hub couplings.
                print(
                    f"[tpu3drecon] hub/global camera split in effect; band "
                    f"preconditioner {config.precond!r} replaced with "
                    "schur_jacobi (ssor/tridiag need pure window locality)",
                    file=sys.stderr,
                )
                config = config._replace(precond="schur_jacobi")
            make_solver = make_wtt_ba_solver
    if args.engine == "grid":
        from tpu3drecon.problems.grid import grid_from_flat
        from tpu3drecon.solvers.ba_grid import make_grid_ba_solver

        from tpu3drecon.utils.placement import commit

        packed = commit(grid_from_flat(problem))
        make_solver = make_grid_ba_solver
    elif args.engine == "tt":
        from tpu3drecon.problems.tt import tt_from_flat
        from tpu3drecon.solvers.ba_tt import make_tt_ba_solver

        from tpu3drecon.utils.placement import commit

        packed = commit(tt_from_flat(problem))
        make_solver = make_tt_ba_solver
    elif args.engine == "flat":
        packed = problem
        make_solver = make_ba_solver

    checkpoint_dir = getattr(args, "checkpoint_dir", None)
    if checkpoint_dir:
        from tpu3drecon.utils.checkpoint import ba_solve_checkpointed

        # Resumable chunked solve: a killed run restarts from the last
        # completed chunk (reference only checkpoints whole benchmark
        # pickles: src/benchmark/benchmark.py:46-70 — this exceeds it).
        t0 = time.perf_counter()
        cams, pts, state = ba_solve_checkpointed(
            packed, config, checkpoint_dir,
            chunk_iters=args.checkpoint_every,
            solver_fn=lambda p, c: make_solver(c)(p),
        )
        jax.block_until_ready(pts)
        solve_s = time.perf_counter() - t0
        compile_s = 0.0
        if state is None:
            print(
                f"[tpu3drecon] checkpoint at {checkpoint_dir} already covers "
                f"maxiter={config.maxiter}; returning checkpointed solution",
                file=sys.stderr,
            )
            rmse1 = float(reprojection_rmse(problem, cams, pts))
            print(
                f"[tpu3drecon] {args.engine} engine on "
                f"{jax.default_backend()}: RMSE {rmse0:.4f} -> {rmse1:.5f} px "
                "(resumed complete)",
                file=sys.stderr,
            )
            return cams, pts, state
    else:
        solver = make_solver(config)
        run = lambda: solver(packed)  # noqa: E731
        t0 = time.perf_counter()
        cams, pts, state = run()
        jax.block_until_ready(pts)
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cams, pts, state = run()
        jax.block_until_ready(pts)
        solve_s = time.perf_counter() - t0
    rmse1 = float(reprojection_rmse(problem, cams, pts))
    print(
        f"[tpu3drecon] {args.engine} engine on {jax.default_backend()}: "
        f"RMSE {rmse0:.4f} -> {rmse1:.5f} px, "
        f"{int(state.accepted)}/{int(state.iter_num)} iters accepted, "
        f"solve {solve_s:.2f}s (compile {compile_s:.1f}s)",
        file=sys.stderr,
    )
    return cams, pts, state


def cmd_solve_bal(args):
    jax = _setup_backend(args)
    import jax.numpy as jnp

    from tpu3drecon.io.bal import ba_problem_from_bal, export_bal

    dtype = jnp.float64 if args.f64 else jnp.float32
    problem, meta = ba_problem_from_bal(args.input, dtype=dtype)
    print(
        f"[tpu3drecon] loaded {args.input}: {problem.n_cameras} cams / "
        f"{problem.n_points} pts / {meta.n_real_obs} obs",
        file=sys.stderr,
    )
    cams, pts, state = _solve(problem, args, jax)
    if args.output:
        export_bal(args.output, problem, cams, pts)
        print(f"[tpu3drecon] wrote {args.output}", file=sys.stderr)
    return 0


def cmd_solve_colmap(args):
    jax = _setup_backend(args)
    import numpy as np
    import jax.numpy as jnp

    from tpu3drecon.io import colmap as cio
    from tpu3drecon.problems.packing import ba_problem_from_colmap

    model = cio.read_model(args.input)
    dtype = jnp.float64 if args.f64 else jnp.float32
    problem, meta = ba_problem_from_colmap(model, dtype=dtype)
    print(
        f"[tpu3drecon] loaded {args.input}: {problem.n_cameras} cams / "
        f"{problem.n_points} pts / {meta.n_real_obs} obs",
        file=sys.stderr,
    )
    cams, pts, state = _solve(problem, args, jax)
    if args.output:
        from tpu3drecon.problems.packing import colmap_model_with_solution

        solved = colmap_model_with_solution(model, cams, pts, meta)
        cio.write_model(solved, args.output, binary=args.binary)
        print(f"[tpu3drecon] wrote {args.output}", file=sys.stderr)
    return 0


def cmd_bench(args):
    """Run bench.py in a child process.  This parent never imports jax's
    backend, so the child is the only process on the card."""
    import subprocess
    from pathlib import Path

    bench = Path(__file__).resolve().parents[1] / "bench.py"
    cmd = [sys.executable, str(bench)] + (["--cpu"] if args.cpu else [])
    return subprocess.call(cmd)


def cmd_info(args):
    import jax

    import tpu3drecon
    from tpu3drecon.io.colmap import native

    from tpu3drecon.utils.device import device_info

    print(json.dumps({
        "version": getattr(tpu3drecon, "__version__", "0.2"),
        "device": device_info().as_dict(),
        "devices": [str(d) for d in jax.devices()],
        "native_io": native.load_library() is not None,
        "engines": ["flat (implicit Schur)", "grid (scatter-free)",
                    "tt (gather-free track table)",
                    "wtt (windowed track table, BAL-scale)",
                    "sharded_grid (multi-device)", "sharded_tt (multi-device)",
                    "sharded_wtt (multi-device)"],
    }, indent=2))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpu3drecon")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("solve-bal", help="bundle-adjust a BAL problem file")
    p.add_argument("input")
    p.add_argument("-o", "--output", default=None, help="write solved BAL file")
    _add_common(p)
    p.set_defaults(fn=cmd_solve_bal)

    p = sub.add_parser("solve-colmap", help="bundle-adjust a COLMAP sparse model")
    p.add_argument("input")
    p.add_argument("-o", "--output", default=None, help="write solved sparse model")
    p.add_argument("--binary", action="store_true", help="write .bin (default .txt)")
    _add_common(p)
    p.set_defaults(fn=cmd_solve_colmap)

    p = sub.add_parser("bench", help="run the headline benchmark")
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("info", help="backend + capability report")
    p.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
