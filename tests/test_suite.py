"""bench.py --suite config runners (tpu3drecon/benchmark/suite.py).

Each BASELINE.md config must be runnable at tiny scale on the CPU mesh and
emit a well-formed result dict with error bars; the full-scale defaults are
exercised on the card by ``python bench.py --suite``.
"""

import numpy as np

from tpu3drecon.benchmark import suite


def _check_schema(res, unit):
    # vs_baseline only where a same-run baseline exists (scipy oracle,
    # the RMSE target); no line carries a recorded number from another
    # machine.
    assert set(res) - {"vs_baseline"} == {"metric", "value", "unit", "extra"}
    assert res["unit"] == unit
    for key in ("median_s", "min_s", "max_s", "reps", "compile_s"):
        assert key in res["extra"], key
    assert res["extra"]["min_s"] <= res["extra"]["median_s"] <= res["extra"]["max_s"]


def test_pnp_parity_tiny():
    res = suite.run_pnp_parity(reps=2, n_cameras=2, n_points=300, seed=5)
    _check_schema(res, "s")
    # Parity vs the in-run scipy oracle at the BASELINE f32-tolerance bar.
    assert res["extra"]["max_rot_geodesic_err_vs_scipy_rad"] < 1e-4
    assert res["extra"]["max_tvec_err_vs_scipy"] < 2e-3
    assert res["extra"]["scipy_oracle_s"] > 0


def test_small_ba_tiny():
    res = suite.run_small_ba(reps=2, n_cameras=4, n_points=400, seed=11)
    _check_schema(res, "px")
    # The BASELINE.md config #2 target: RMSE within 1e-3 px.
    assert res["value"] < 1e-3
    assert res["vs_baseline"] > 1.0


def test_tracking_tiny():
    res = suite.run_tracking(reps=2, n_frames=4, n_obs=120, seed=81)
    _check_schema(res, "ms/frame")
    assert res["extra"]["median_tvec_err"] < 1e-3
    assert res["extra"]["single_executable"] is True


def test_bal_ratio_tiny():
    res = suite.run_bal(
        reps=1, lm_iters=2, full_scale=False, ratio_cams=24, ratio_ppc=40
    )
    _check_schema(res, "s/LM-iter")
    assert res["extra"]["full_scale"] is False
    assert res["extra"]["accepted_steps"] >= 1
    assert np.isfinite(res["extra"]["loss"])
