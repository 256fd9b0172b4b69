"""Test configuration: force a virtual 8-device CPU mesh before jax imports.

Multi-device sharding tests run against this CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8).  Nothing here needs
an accelerator; the card is exercised by chip_smoke.py and bench.py.
"""

import os

# jax.config.update below switches the platform even when jax was imported
# before this file ran; XLA_FLAGS still works because the CPU client
# initializes lazily.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Double precision on the CPU test mesh so math tests can check tight
# tolerances; the library itself is dtype-explicit and runs f32 on the card.
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy multi-device / scale / f64-equality tests "
        "(excluded from the fast tier)",
    )
    config.addinivalue_line(
        "markers",
        "fast: <5-minute tier covering every module's core invariants "
        "(auto-applied to everything not marked slow; run with -m fast)",
    )


# Heavy tests (>=~15 s on the virtual CPU mesh, measured suite durations):
# multi-device f64 equality, GT-recovery solves, subprocess harnesses.
# Matched by nodeid substring and marked slow; everything else is the fast
# tier (`pytest -m fast` — every module's core invariants in <5 min).
_SLOW_NODE_PATTERNS = (
    # Round-4 fast-tier budget trim (measured with -n 8 --durations on a
    # loaded host; each module keeps cheaper invariant coverage in-tier):
    "test_ba_wtt.py::TestDeferredOnehot::test_solve_equality_via_deferred",
    "test_tridiag.py::TestSSOR::test_wtt_engine_ssor_matches_tt",
    "test_tridiag.py::TestSSOR::test_tt_engine_ssor",
    "test_tridiag.py::TestTTTridiag::test_offdiag_blocks_exact",
    "test_tridiag.py::TestWTTTridiag::test_wtt_matches_tt_trajectory",
    "test_tridiag.py::TestTTTridiag::test_solve_equals_schur_jacobi_at_convergence",
    "test_utils.py::TestProblemCache::test_wtt_problem_round_trips",
    "test_suite.py::test_bal_ratio_tiny",
    "test_reorder.py::TestHubSplit::test_band_precond_rejected_with_hub_tiles",
    "test_reorder.py::TestHubSplit::test_split_windows_matches_on_hub",
    "test_reorder.py::TestHubSplit::test_capped_hub_fully_indexed_deferred",
    "test_reorder.py::TestHubSplit::test_global_tile_hulls",
    "test_ba_wtt.py::TestSplitWindows::test_solve_equality",
    "test_ba_wtt.py::TestSplitWindows::test_chunk_multiple_padding",
    "test_cli.py::test_solve_bal_wtt_infeasible_falls_back_to_grid",
    "test_sharded_wtt.py",
    "test_sharded_tt.py",
    "test_sharded_grid.py",
    "test_sharding.py::test_sharded_matches_single_device",
    "test_sharding.py::test_sharded_pose_refinement_batch_dp",
    "test_sharding.py::test_bal_class_shapes_dry_run",
    "test_ba_wtt.py::TestWTTSolve",
    "test_ba_wtt.py::TestWTTPrincipalPointAtScale",
    "test_intrinsics_refine.py::test_ba_with_intrinsics_calibration",
    "test_ba_tt.py::TestTTSolveModes",
    "test_utils.py::TestMultiprocess::test_list_processor_parallel",
    "test_utils.py::TestCheckpoint",
    "test_cli.py::test_solve_bal_track_table_engines",
    "test_cli.py::test_solve_bal_precond_flag",
    "test_cli.py::test_solve_colmap_writeback",
    "test_cli.py::test_solve_bal_writes_output",
    "test_cli.py::test_checkpoint_kill_and_resume",
    "test_pose_refine.py::test_float32_path",
    "test_tracking.py::test_many_frames_single_executable",
    "test_bundle_adjust.py::TestScaling::test_beyond_reference_ceiling",
    "test_reorder.py::TestWTTReorder::test_solve_matches_tt_on_shuffled",
    "test_reorder.py::TestHubSplit::test_solve_matches_tt",
    "test_reorder.py::TestHubSplit::test_auto_packs_hub_split_under_budget",
    "test_ba_tt.py::TestTTSolveEquality::test_matches_grid_engine",
    "test_benchmark_harness.py::TestSubprocessIsolation",
    "test_benchmark_harness.py::TestDrivers::test_cost_curve_plot",
    "test_ba_grid.py::TestGridSolve::test_matches_flat_solve",
    "test_benchmark_harness.py::TestReconBundleAdjustment",
    "test_benchmark_harness.py::TestReconSinglePose",
    "test_compat.py::TestJaxPoseOptimizerCompat::test_end_to_end",
    "test_compat.py::TestJaxBundleAdjustmentCompat::test_end_to_end",
    "test_bal.py::test_problem_packs_and_solves",
    "test_bal.py::test_distorted_bal_loader_and_solve",
    "test_bundle_adjust.py::TestConfigurations::test_float32",
    "test_bundle_adjust.py::TestConfigurations::test_fixed_focal",
)


def pytest_collection_modifyitems(config, items):
    for item in items:
        if any(p in item.nodeid for p in _SLOW_NODE_PATTERNS):
            item.add_marker(pytest.mark.slow)
        if "slow" not in item.keywords:
            item.add_marker(pytest.mark.fast)


# Fast-tier wall budget (seconds).  CLAUDE.md hard budget is <=8 min on a
# loaded host; the tier drifted over it three rounds in a row with only
# manual re-measurement catching it, so the suite now self-reports and
# warns mechanically (round-5 verdict item 8).  Override:
# TPU3DRECON_FAST_BUDGET_S.
_FAST_BUDGET_S = float(os.environ.get("TPU3DRECON_FAST_BUDGET_S", "480"))
_session_t0 = None


def pytest_sessionstart(session):
    global _session_t0
    import time

    _session_t0 = time.monotonic()


def pytest_terminal_summary(terminalreporter, exitstatus, config):
    """Emit the fast-tier wall time and warn loudly over budget.

    Warn rather than fail: the budget is defined on a loaded shared host
    and wall time varies ~2x with co-tenants — a hard fail would be
    flaky.  The warning names the re-trim procedure so drift gets acted
    on instead of scrolling by.
    """
    if "fast" not in (config.getoption("-m") or ""):
        return
    if _session_t0 is None:
        return
    import time

    wall = time.monotonic() - _session_t0
    tr = terminalreporter
    tr.write_sep("-", f"fast tier wall: {wall:.0f}s (budget {_FAST_BUDGET_S:.0f}s)")
    if wall > _FAST_BUDGET_S:
        tr.write_line(
            f"FAST TIER OVER BUDGET: {wall:.0f}s > {_FAST_BUDGET_S:.0f}s. "
            "Re-measure with --durations=40 and move the top offenders "
            "into conftest._SLOW_NODE_PATTERNS (CLAUDE.md budget rule).",
            red=True, bold=True,
        )


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_modules(request):
    """Free compiled executables after each test module.

    XLA:CPU's JIT segfaults DETERMINISTICALLY inside
    ``backend_compile_and_load`` when the process has accumulated many
    compiled programs and then compiles the largest one
    (test_sharded_wtt::test_joint_distortion_sharded after ~59 prior
    tests); the same test passes in a fresh process.  Dropping the
    executable caches between modules keeps the compiler below whatever
    resource limit it is tripping.  Costs cross-module recompiles of the
    shared solver caches (~1 min over the suite).

    Fast-tier runs (-m fast) skip the clearing: the trap only ever fired
    on the big sharded compiles, which are all marked slow, and keeping
    the caches saves ~1 min of the <5-minute tier.
    """
    yield
    if "fast" in (request.config.getoption("-m") or ""):
        return
    import jax

    jax.clear_caches()


@pytest.fixture(scope="session", autouse=True)
def _disable_compile_cache():
    """Make any in-test enable_compilation_cache() a no-op.

    The CLI (tpu3drecon/cli.py) enables jax's persistent compilation cache;
    once test_cli runs it in-process the config sticks for the REST of the
    suite.  Two separate suite runs have segfaulted inside jax's cache
    machinery (once reading a zstd entry from the shared repo cache, once
    in put_executable_and_time writing to an ISOLATED tmp dir), so tests
    disable the cache entirely — it buys nothing on the fast-compiling
    virtual CPU mesh.
    """
    os.environ["TPU3DRECON_CACHE_DISABLE"] = "1"
    yield
    os.environ.pop("TPU3DRECON_CACHE_DISABLE", None)
