"""Headline benchmark: medium bundle adjustment, 100 cams / 100k pts / 200k obs.

BASELINE.json config #3 ("Medium BA with intrinsics refinement: ~100 cams /
100k points").  Runs a fixed 30-outer-iteration implicit-Schur LM solve
(identical deterministic work on every engine and backend) on one
accelerator and prints ONE JSON line naming the device it ran on.

The engine is one explicit choice (``--engine``); the default is the engine
measured fastest at identical work on one H100, all four in one process
(CHANGES.md).  There is no fallback: with no accelerator the run fails, and
``--cpu`` runs on the host on purpose (its output then says ``cpu``).

vs_baseline = CPU_PIN_S / median time.  The pin is the flat engine's time
for the same solve on a development sandbox's CPU; it is a host figure, not
an accelerator one.  The original reference (jaxopt dense-J LM) cannot run
this problem size at all (dense J would be ~200k x 300k).

    python bench.py                 # default engine on the accelerator
    python bench.py --engine wtt    # one named engine
    python bench.py --cpu           # the host CPU, on purpose
    python bench.py --suite         # every BASELINE.md config, one line each
"""

from __future__ import annotations

import json
import sys

# Flat engine, f32, 30 LM iterations of this solve on a development
# sandbox's CPU (single jax CPU device, all cores, idle host, fastest of
# repeated runs; 2026-08-17).  A host figure kept for continuity only.
CPU_PIN_S = 6.1356
CPU_PIN_DESC = "flat engine, f32, development sandbox CPU, 2026-08-17"

# The engine measured fastest on the medium config on one H100, all four
# engines in one process at identical work (CHANGES.md).
DEFAULT_ENGINE = "flat"


def _median(ts):
    ts = sorted(ts)
    n = len(ts)
    return ts[n // 2] if n % 2 else 0.5 * (ts[n // 2 - 1] + ts[n // 2])


def emit_headline(force_cpu: bool = False, cg: int | None = None,
                  engine: str = DEFAULT_ENGINE) -> dict:
    """Run the headline solve on ``engine`` and print its JSON line."""
    import jax

    from tpu3drecon.utils.compile_cache import (
        cache_dir,
        cache_entry_count,
        enable_compilation_cache,
    )
    from tpu3drecon.utils.device import device_info, require_accelerator

    if force_cpu:
        jax.config.update("jax_platforms", "cpu")
        info = device_info()
    else:
        info = require_accelerator(what="bench.py")
    cache_entries_before = cache_entry_count()
    enable_compilation_cache()

    from tpu3drecon.benchmark.medium_config import (
        BENCH_CONFIG,
        build_problem,
        prepare_engine,
        timed_solve_stats,
    )
    from tpu3drecon.solvers.bundle_adjust import reprojection_rmse
    from tpu3drecon.utils.placement import commit

    # --cg N overrides the CG budget (a dynamic operand: the cg=8
    # executable is reused).  The headline stays cg=8.
    cfg = BENCH_CONFIG if cg is None else BENCH_CONFIG._replace(cg_maxiter=cg)
    reps = 2 if force_cpu else 5
    flat_host = build_problem(on_host=True)
    solver, problem = prepare_engine(engine, cfg, flat_host)
    compile_s, times, (cams, pts, state) = timed_solve_stats(
        solver, problem, repeats=reps
    )
    run_s = _median(times)
    rmse = float(reprojection_rmse(commit(flat_host), cams, pts))

    result = {
        "metric": "ba_medium_100cam_100kpt_30lm_iters",
        "value": round(run_s, 4),
        "unit": "s",
        "vs_baseline": round(CPU_PIN_S / run_s, 2),
        "device": info.as_dict(),
        "extra": {
            "median_s": round(run_s, 4),
            "min_s": round(min(times), 4),
            "max_s": round(max(times), 4),
            "reps": len(times),
            "compile_s": round(compile_s, 2),
            "reproj_rmse_px": float(f"{rmse:.3e}"),
            "accepted_steps": int(state.accepted),
            "engine": engine,
            "n_obs": 200704,
            "cpu_pin_s": CPU_PIN_S,
            "cpu_pin_desc": CPU_PIN_DESC,
            "compile_cache_dir": str(cache_dir()),
            "warm_cache": cache_entries_before > 0,
        },
    }
    if cg is not None:
        result["extra"]["cg_maxiter"] = cg
    print(json.dumps(result))
    return result


def main(argv=None) -> int:
    import argparse

    from tpu3drecon.benchmark.medium_config import ENGINES
    from tpu3drecon.utils.device import NoAcceleratorError

    ap = argparse.ArgumentParser(
        description="Headline benchmark (one JSON line); --suite runs every "
        "BASELINE.md config (one JSON line each)."
    )
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host CPU on purpose")
    ap.add_argument("--engine", choices=ENGINES, default=DEFAULT_ENGINE,
                    help=f"BA engine for the headline (default {DEFAULT_ENGINE})")
    ap.add_argument("--cg", type=int, default=None, metavar="N",
                    help="override the CG budget (headline is 8)")
    ap.add_argument("--suite", action="store_true",
                    help="run all five BASELINE.md configs (PnP parity, "
                    "small BA, medium BA, 500-frame tracking, BAL s/LM-iter)")
    args = ap.parse_args(argv)

    try:
        if args.suite:
            from tpu3drecon.benchmark.suite import run_suite

            run_suite(force_cpu=args.cpu, cg=args.cg, engine=args.engine)
        else:
            emit_headline(force_cpu=args.cpu, cg=args.cg, engine=args.engine)
    except NoAcceleratorError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
