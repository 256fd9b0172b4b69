"""The shared medium-BA benchmark configuration (bench.py + baselines).

BASELINE.json config #3: "Medium BA with intrinsics refinement: ~100 cams /
100k points".  Fixed seeds and fixed iteration counts so the benchmark work
is deterministic across runs and backends.
"""

from __future__ import annotations

import time

import jax

from tpu3drecon.solvers.bundle_adjust import BAConfig

N_CAMERAS = 100
N_POINTS = 100_000
OBS_PER_CAMERA = 2_000
SEED = 42

# Fixed-work config: run exactly LM_ITERS outer iterations (no early stop) so
# wall-clock comparisons measure identical work.  Round-2 tuning (RESULTS.md):
# the SCHUR_JACOBI preconditioner (exact S-diagonal blocks) reaches the
# round-1 final RMSE (1.19e-5 px vs 1.18e-5) with cg_maxiter=8 instead of the
# block-Jacobi-on-U setting's 12; every backend and engine runs the
# identical config.
LM_ITERS = 30
BENCH_CONFIG = BAConfig(
    maxiter=LM_ITERS,
    gtol=0.0,
    ftol=0.0,
    cg_maxiter=8,
    cg_rtol=1e-4,
    precond="schur_jacobi",
)


def build_problem(dtype=None, on_host: bool = False,
                  n_cameras: int = N_CAMERAS, n_points: int = N_POINTS,
                  obs_per_camera: int = OBS_PER_CAMERA):
    """Build the medium problem; ``on_host=True`` keeps arrays on the CPU
    device, for the host-side repacking of the grid/track-table engines
    (place the result with utils.placement.commit).  The size arguments
    exist so tests can shrink the scene; the defaults ARE the config."""
    import jax
    import jax.numpy as jnp

    from tpu3drecon.dataset.synthetic import (
        make_scene,
        perturb_scene,
        scene_to_ba_problem,
    )

    def _build():
        scene = make_scene(
            n_cameras=n_cameras,
            n_points=n_points,
            obs_per_camera=obs_per_camera,
            seed=SEED,
        )
        noisy = perturb_scene(scene, seed=SEED + 1, point2d_noise=0.5)
        problem, _ = scene_to_ba_problem(
            noisy, observed=scene, dtype=dtype or jnp.float32
        )
        return problem

    if on_host:
        with jax.default_device(jax.local_devices(backend="cpu")[0]):
            return _build()
    return _build()


# The four XLA engines, all step-equivalent (same LM/implicit-Schur
# trajectory, asserted in the tests): flat segment-sum, scatter-free grid,
# gather-free track table, windowed track table.
ENGINES = ("flat", "grid", "tt", "wtt")


def engine_solver(engine: str, config: BAConfig = BENCH_CONFIG):
    """The cached jitted solver of one engine for ``config``."""
    if engine == "flat":
        from tpu3drecon.solvers.bundle_adjust import make_ba_solver as make
    elif engine == "grid":
        from tpu3drecon.solvers.ba_grid import make_grid_ba_solver as make
    elif engine == "tt":
        from tpu3drecon.solvers.ba_tt import make_tt_ba_solver as make
    elif engine == "wtt":
        from tpu3drecon.solvers.ba_wtt import make_wtt_ba_solver as make
    else:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    return make(config)


def pack_for_engine(engine: str, flat_host):
    """The flat problem (built on the host CPU device) packed host-side for
    ``engine`` and placed on the default device in one step."""
    from tpu3drecon.utils.placement import commit

    if engine == "flat":
        return commit(flat_host)
    if engine == "grid":
        from tpu3drecon.problems.grid import grid_from_flat as pack
    elif engine == "tt":
        from tpu3drecon.problems.tt import tt_from_flat as pack
    elif engine == "wtt":
        from tpu3drecon.problems.wtt import wtt_from_flat as pack
    else:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    return commit(pack(flat_host))


def prepare_engine(engine: str, config: BAConfig = BENCH_CONFIG,
                   flat_host=None):
    """(solver, packed problem on the default device) for one engine."""
    if flat_host is None:
        flat_host = build_problem(on_host=True)
    return engine_solver(engine, config), pack_for_engine(engine, flat_host)


def timed_solve_stats(solver, problem, repeats: int = 1):
    """Compile (warm-up) then time; returns (compile_s, run_times, result).

    ``run_times`` is the full per-repetition list so callers can report a
    median and spread — a single draw carries no error bar.

    The compile/run split follows the reference's measurement protocol
    (benchmark_pose_optimization.py:165-182, benchmark_bundle_adjustment.py:
    171-181): warm-up solve counted separately, block_until_ready around the
    timed region.
    """
    t0 = time.perf_counter()
    out = jax.block_until_ready(solver(problem))
    compile_s = time.perf_counter() - t0

    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(solver(problem))
        times.append(time.perf_counter() - t0)
    return compile_s, times, out
