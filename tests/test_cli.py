"""CLI end-to-end: solve-bal, solve-colmap (writeback), info."""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest

from tpu3drecon.cli import main


@pytest.fixture(scope="module")
def bal_file(tmp_path_factory):
    from tests.test_bal import _make_bal_scene
    from tpu3drecon.io.bal import write_bal

    cam_idx, pt_idx, uv, cam_params, points = _make_bal_scene(seed=131)
    # Noisy init so the solve has work to do.
    rng = np.random.default_rng(2)
    cam_params = cam_params.copy()
    points = points + rng.normal(scale=0.01, size=points.shape)
    path = tmp_path_factory.mktemp("cli") / "p.txt"
    write_bal(str(path), cam_idx, pt_idx, uv, cam_params, points)
    return str(path)


def test_solve_bal_writes_output(bal_file, tmp_path, capsys):
    out = tmp_path / "solved.txt"
    rc = main([
        "solve-bal", bal_file, "-o", str(out),
        "--cpu", "--maxiter", "15", "--no-focal", "--f64",
    ])
    assert rc == 0
    from tpu3drecon.io.bal import ba_problem_from_bal
    from tpu3drecon.solvers.bundle_adjust import reprojection_rmse

    solved, _ = ba_problem_from_bal(str(out))
    rmse = float(reprojection_rmse(solved, solved.cameras, solved.points3d))
    assert rmse < 0.05


@pytest.mark.parametrize("engine", ["tt", "wtt", "grid"])
def test_solve_bal_track_table_engines(bal_file, tmp_path, engine):
    out = tmp_path / f"solved_{engine}.txt"
    rc = main([
        "solve-bal", bal_file, "-o", str(out),
        "--cpu", "--maxiter", "15", "--no-focal", "--f64",
        "--engine", engine,
    ])
    assert rc == 0
    from tpu3drecon.io.bal import ba_problem_from_bal
    from tpu3drecon.solvers.bundle_adjust import reprojection_rmse

    solved, _ = ba_problem_from_bal(str(out))
    rmse = float(reprojection_rmse(solved, solved.cameras, solved.points3d))
    assert rmse < 0.05


def test_solve_bal_precond_flag(bal_file, tmp_path):
    """--precond ssor drives the band preconditioner end to end (tt)."""
    out = tmp_path / "solved_ssor.txt"
    rc = main([
        "solve-bal", bal_file, "-o", str(out),
        "--cpu", "--maxiter", "15", "--no-focal", "--f64",
        "--engine", "tt", "--precond", "ssor",
    ])
    assert rc == 0
    from tpu3drecon.io.bal import ba_problem_from_bal
    from tpu3drecon.solvers.bundle_adjust import reprojection_rmse

    solved, _ = ba_problem_from_bal(str(out))
    rmse = float(reprojection_rmse(solved, solved.cameras, solved.points3d))
    assert rmse < 0.05


def test_precond_engine_validation(bal_file, tmp_path, capsys):
    """Band preconditioners with non-track-table engines exit cleanly
    (code 2 + message), instead of a raw solver ValueError traceback."""
    with pytest.raises(SystemExit) as exc:
        main([
            "solve-bal", bal_file, "-o", str(tmp_path / "x.txt"),
            "--cpu", "--engine", "flat", "--precond", "ssor",
        ])
    assert exc.value.code == 2
    assert "requires --engine tt or wtt" in capsys.readouterr().err


def test_precond_auto_selection():
    """auto = ssor for track-table engines at >=1000 cams (RESULTS.md),
    schur_jacobi otherwise."""
    import argparse

    from tpu3drecon.cli import _config

    def mk(engine, precond="auto"):
        return argparse.Namespace(
            engine=engine, precond=precond, maxiter=5, cg_maxiter=8,
            no_focal=False, loss="trivial",
        )

    assert _config(mk("wtt"), n_cameras=1712).precond == "ssor"
    assert _config(mk("tt"), n_cameras=1712).precond == "ssor"
    assert _config(mk("wtt"), n_cameras=100).precond == "schur_jacobi"
    assert _config(mk("grid"), n_cameras=1712).precond == "schur_jacobi"
    assert _config(mk("wtt", "schur_jacobi"), n_cameras=1712).precond == "schur_jacobi"
    assert _config(mk("tt", "tridiag"), n_cameras=10).precond == "tridiag"


def test_split_windows_flag_validation():
    """--split-windows is a wtt packing concept: other engines reject it
    as a clean exit-2 usage error instead of silently ignoring it; the
    value parses as auto/on/off or a positive int class cap."""
    import argparse

    from tpu3drecon.cli import _config, _split_windows_arg

    def mk(engine, split_windows):
        return argparse.Namespace(
            engine=engine, precond="auto", split_windows=split_windows,
            maxiter=5, cg_maxiter=8, no_focal=False, loss="trivial",
        )

    for engine, sw in (("tt", "on"), ("grid", "off"), ("tt", 6)):
        with pytest.raises(SystemExit) as exc:
            _config(mk(engine, sw), n_cameras=100)
        assert exc.value.code == 2
    assert _split_windows_arg("auto") == "auto"
    assert _split_windows_arg("6") == 6
    for bad in ("0", "-3", "always"):
        with pytest.raises(argparse.ArgumentTypeError):
            _split_windows_arg(bad)


@pytest.mark.parametrize(
    "flags",
    [["--engine", "pallas"], ["--matvec", "index"], ["--linearize", "index"],
     ["--aot"]],
    ids=["engine-pallas", "matvec", "linearize", "aot"],
)
def test_removed_flags_rejected(bal_file, flags, capsys):
    """The kernel and executable-cache flags are gone: argparse refuses
    them (exit 2) before any solve starts."""
    with pytest.raises(SystemExit) as exc:
        main(["solve-bal", bal_file, "--cpu", *flags])
    assert exc.value.code == 2
    assert "error" in capsys.readouterr().err


def test_engine_choices():
    """The CLI offers exactly the four XLA engines, flat by default."""
    from tpu3drecon.cli import ENGINES

    assert ENGINES == ("flat", "grid", "tt", "wtt")
    import argparse

    from tpu3drecon.cli import _add_common

    p = argparse.ArgumentParser()
    _add_common(p)
    assert p.parse_args([]).engine == "flat"


def test_solve_bal_wtt_infeasible_falls_back_to_grid(
    bal_file, tmp_path, monkeypatch, capsys
):
    """VERDICT #2: when the windowed layout is infeasible (too little camera
    locality even after RCM relabeling — wtt.py raises ValueError), the CLI
    must fall back to the layout-agnostic grid engine and still solve."""
    import tpu3drecon.problems.wtt as wtt_mod

    def _infeasible(*a, **k):
        raise ValueError("windowed one-hots would be 99.00 GB (simulated)")

    monkeypatch.setattr(wtt_mod, "wtt_from_flat", _infeasible)
    out = tmp_path / "solved_fallback.txt"
    rc = main([
        "solve-bal", bal_file, "-o", str(out),
        "--cpu", "--maxiter", "15", "--no-focal", "--f64",
        "--engine", "wtt",
    ])
    captured = capsys.readouterr()
    assert rc == 0
    assert "falling back to the grid engine" in captured.err
    from tpu3drecon.io.bal import ba_problem_from_bal
    from tpu3drecon.solvers.bundle_adjust import reprojection_rmse

    solved, _ = ba_problem_from_bal(str(out))
    rmse = float(reprojection_rmse(solved, solved.cameras, solved.points3d))
    assert rmse < 0.05


def test_solve_colmap_writeback(tmp_path):
    from tpu3drecon.dataset.synthetic import (
        make_scene,
        perturb_scene,
        scene_to_colmap_model,
    )
    from tpu3drecon.io import colmap as cio

    scene = make_scene(n_cameras=5, n_points=200, seed=7)
    noisy = perturb_scene(scene, seed=8, point2d_noise=0.0)
    model = scene_to_colmap_model(dataclasses.replace(noisy, uv=scene.uv))
    src = tmp_path / "sparse"
    dst = tmp_path / "sparse_opt"
    cio.write_model(model, str(src), binary=True)

    rc = main([
        "solve-colmap", str(src), "-o", str(dst), "--binary",
        "--cpu", "--maxiter", "25", "--f64",
    ])
    assert rc == 0
    solved = cio.read_model(str(dst))
    # Solution must differ from input (points moved toward GT) and keep ids.
    np.testing.assert_array_equal(solved.points.ids, model.points.ids)
    assert not np.allclose(np.asarray(solved.points.xyz), np.asarray(model.points.xyz))
    from tpu3drecon.problems.packing import ba_problem_from_colmap
    from tpu3drecon.solvers.bundle_adjust import reprojection_rmse

    problem, _ = ba_problem_from_colmap(solved)
    rmse = float(reprojection_rmse(problem, problem.cameras, problem.points3d))
    assert rmse < 1e-3


def test_info_runs(capsys):
    rc = main(["info"])
    assert rc == 0
    payload = json.loads(capsys.readouterr().out)
    assert "engines" in payload and payload["native_io"] in (True, False)


def test_checkpoint_kill_and_resume(bal_file, tmp_path):
    """A killed chunked CLI solve resumes from its checkpoint to the same
    final solution as an uninterrupted chunked run (round-4 verdict item 6)."""
    import os
    import signal
    import time

    from tpu3drecon.io.bal import ba_problem_from_bal

    def cmd(ckdir, out):
        # cg_maxiter 2 = inexact steps: the solve cannot converge inside
        # one chunk, so every run walks all four chunk boundaries.
        return [
            sys.executable, "-m", "tpu3drecon", "solve-bal", bal_file,
            "-o", str(out), "--cpu", "--f64", "--maxiter", "12",
            "--cg-maxiter", "2", "--checkpoint-every", "3",
            "--checkpoint-dir", str(ckdir),
        ]

    # Reference: uninterrupted chunked run.
    ref_out = tmp_path / "ref.txt"
    subprocess.run(
        cmd(tmp_path / "ck_ref", ref_out), check=True, cwd="/root/repo",
        timeout=300,
    )

    # Victim: kill -9 as soon as the first checkpoint chunk lands.  The
    # fault-injection delay holds the process inside a deterministic
    # window after each checkpoint write.
    ckdir = tmp_path / "ck"
    out = tmp_path / "solved.txt"
    env = dict(os.environ, TPU3DRECON_CHECKPOINT_DELAY_S="5")
    proc = subprocess.Popen(cmd(ckdir, out), cwd="/root/repo", env=env)
    deadline = time.time() + 240
    try:
        while time.time() < deadline:
            if ckdir.is_dir() and any(
                p.name.startswith("step_") for p in ckdir.iterdir()
            ):
                break
            if proc.poll() is not None:
                pytest.fail("solve finished before the kill window")
            time.sleep(0.2)
        else:
            pytest.fail("no checkpoint appeared in time")
        time.sleep(0.5)  # let orbax finish its atomic rename
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)
    assert not out.exists()  # killed before writing the solution

    # Resume: same command, same checkpoint dir, runs to completion.
    subprocess.run(cmd(ckdir, out), check=True, cwd="/root/repo", timeout=300)
    resumed, _ = ba_problem_from_bal(str(out))
    ref, _ = ba_problem_from_bal(str(ref_out))
    np.testing.assert_allclose(
        np.asarray(resumed.points3d), np.asarray(ref.points3d), atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(resumed.cameras.tvecs), np.asarray(ref.cameras.tvecs),
        atol=1e-9,
    )
