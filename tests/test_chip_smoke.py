"""chip_smoke.py's phases at a tiny size on the CPU: the same code the card
runs at the medium config, so a wrong path or check shows here first."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

TINY = dict(n_cameras=6, n_points=300, obs_per_camera=150)


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def test_phase_device(capsys):
    line = chip_smoke.phase_device()
    assert line["phase"] == "device"
    for key in ("platform", "device_kind", "count", "jax_version",
                "xla_flags", "compile_cache_dir", "nvidia_smi"):
        assert key in line, key
    assert _lines(capsys) == [line]


def test_phase_medium_ba_tiny(capsys):
    lines = chip_smoke.phase_medium_ba(reps=1, **TINY)
    assert [ln["engine"] for ln in lines] == ["flat", "grid", "tt", "wtt"]
    printed = _lines(capsys)
    assert printed[0]["phase"] == "medium_ba_reference"
    assert printed[0]["dtype"] == "float64"
    for ln in lines:
        assert ln["rmse_px"] <= chip_smoke.RMSE_TARGET_PX
        assert set(ln["early_cost_rel_diff_vs_f64"]) == set(chip_smoke.COST_CHECKS)
        assert ln["min_s"] <= ln["median_s"] <= ln["max_s"]


def test_phase_medium_ba_fails_loudly(monkeypatch):
    """A cost check that cannot hold must fail the phase, not pass over."""
    monkeypatch.setattr(chip_smoke, "COST_CHECKS", {0: -1.0})
    with pytest.raises(chip_smoke.PhaseFailed, match="cost after 0 LM"):
        chip_smoke.phase_medium_ba(engines=("flat",), reps=1, **TINY)


def test_phase_pose_tiny(capsys):
    lines = chip_smoke.phase_pose(
        dict(reps=1, n_cameras=2, n_points=300),
        dict(reps=1, n_frames=4, n_obs=120),
    )
    assert [ln["phase"] for ln in lines] == ["pose_pnp", "pose_tracking"]


def _small_bal(path):
    from tests.test_bal import _make_bal_scene
    from tpu3drecon.io.bal import write_bal

    cam_idx, pt_idx, uv, cam_params, points = _make_bal_scene(seed=131)
    points = points + np.random.default_rng(2).normal(scale=0.01, size=points.shape)
    write_bal(path, cam_idx, pt_idx, uv, cam_params, points)


def test_phase_cli_tiny(tmp_path, capsys):
    line = chip_smoke.phase_cli(
        str(tmp_path), bal_writer=_small_bal,
        extra_args=("--no-focal", "--cpu", "--maxiter", "15"),
    )
    assert line["rmse_after_px"] < line["rmse_before_px"]
    assert abs(line["rmse_reloaded_px"] - line["rmse_after_px"]) <= 1e-3


def test_phase_sharded_tiny(capsys):
    lines = chip_smoke.phase_sharded(n_devices=4, reps=1, **TINY)
    assert [ln["engine"] for ln in lines] == ["flat", "grid", "tt", "wtt"]
    for ln in lines:
        assert ln["placed_observations"]["device_ids"] == [0, 1, 2, 3]
