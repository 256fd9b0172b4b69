"""Tests for aux subsystems: visualization export, checkpoint/resume, timing."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from tpu3drecon.dataset.synthetic import make_scene, perturb_scene, scene_to_ba_problem
from tpu3drecon.solvers.bundle_adjust import BAConfig, ba_solve, reprojection_rmse
from tpu3drecon.utils import visualization as viz
from tpu3drecon.utils.checkpoint import (
    ba_solve_checkpointed,
    latest_step,
    restore_state,
    save_state,
)
from tpu3drecon.utils.timing import CompileRunTimer, stopwatch


@pytest.fixture(scope="module")
def scene():
    return make_scene(n_cameras=5, n_points=100, seed=91)


class TestVisualization:
    def test_frustum_geometry(self, scene):
        k = np.array(
            [[scene.fx_fy[0, 0], 0, scene.cx_cy_skew[0, 0]],
             [0, scene.fx_fy[0, 1], scene.cx_cy_skew[0, 1]],
             [0, 0, 1]]
        )
        corners = viz.frustum_corners(
            scene.rmats[0], scene.tvecs[0], k, scene.width, scene.height, depth=2.0
        )
        assert corners.shape == (5, 3)
        # Center must be the camera center -R^T t.
        np.testing.assert_allclose(
            corners[0], -scene.rmats[0].T @ scene.tvecs[0], atol=1e-9
        )
        # All corners at depth 2 in the camera frame.
        cam_frame = (corners[1:] - corners[0]) @ scene.rmats[0].T
        np.testing.assert_allclose(cam_frame[:, 2], 2.0, atol=1e-9)

    def test_scene_export(self, scene, tmp_path):
        ks = np.stack(
            [
                [[scene.fx_fy[c, 0], 0, scene.cx_cy_skew[c, 0]],
                 [0, scene.fx_fy[c, 1], scene.cx_cy_skew[c, 1]],
                 [0, 0, 1]]
                for c in range(scene.n_cameras)
            ]
        )
        ply, obj = viz.export_scene(
            str(tmp_path), scene.points3d, scene.rmats, scene.tvecs, ks,
            [scene.width] * scene.n_cameras, [scene.height] * scene.n_cameras,
        )
        assert os.path.exists(ply) and os.path.exists(obj)
        header = open(ply).read().split("end_header")[0]
        assert f"element vertex {scene.n_points}" in header
        obj_text = open(obj).read()
        assert obj_text.count("\nl ") == scene.n_cameras * 8

    def test_dataset_export(self, tmp_path):
        from tpu3drecon.benchmark.datasets import get_dataset

        ds = get_dataset("synthetic_small")
        ply, obj = viz.export_dataset_scene(ds, str(tmp_path))
        assert os.path.exists(ply) and os.path.exists(obj)

    def test_matplotlib_quicklook(self, scene, tmp_path):
        path = viz.plot_scene_matplotlib(
            scene.points3d,
            np.einsum("cji,cj->ci", scene.rmats, -scene.tvecs),
            str(tmp_path / "scene.png"),
        )
        assert os.path.exists(path)


class TestCheckpoint:
    def test_save_restore_round_trip(self, tmp_path):
        state = {"a": jnp.arange(5.0), "b": {"c": jnp.ones((2, 3))}}
        save_state(state, str(tmp_path), 10)
        assert latest_step(str(tmp_path)) == 10
        restored = restore_state(state, str(tmp_path))
        np.testing.assert_array_equal(restored["a"], np.arange(5.0))
        np.testing.assert_array_equal(restored["b"]["c"], np.ones((2, 3)))

    def test_chunked_ba_solve_with_resume(self, scene, tmp_path):
        noisy = perturb_scene(scene, seed=92, point2d_noise=0.0)
        problem, _ = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float64)
        config = BAConfig(maxiter=20, gtol=1e-12, ftol=0.0, cg_rtol=1e-8)
        ckdir = str(tmp_path / "ck")
        cams, pts, state = ba_solve_checkpointed(problem, config, ckdir, chunk_iters=5)
        assert latest_step(ckdir) is not None
        rmse_full = float(reprojection_rmse(problem, cams, pts))
        assert rmse_full < 1e-4

        # Resume: a fresh call continues from the checkpoint instantly.
        cams2, pts2, _ = ba_solve_checkpointed(problem, config, ckdir, chunk_iters=5)
        rmse_resumed = float(reprojection_rmse(problem, cams2, pts2))
        assert rmse_resumed <= rmse_full * 1.5 + 1e-9


class TestTiming:
    def test_compile_run_timer(self):
        import jax

        timer = CompileRunTimer()
        f = jax.jit(lambda x: (x**2).sum())
        out = timer.measure(f, jnp.arange(1000.0), repeats=3)
        assert timer.compile_time is not None and timer.compile_time >= 0
        assert len(timer.run_times) == 3
        jax.block_until_ready(out)

    def test_stopwatch_sink(self):
        sink = {}
        with stopwatch("x", sink):
            pass
        assert "x" in sink and sink["x"] >= 0


class TestMultiprocess:
    def test_list_processor_single(self):
        from tpu3drecon.utils.multiprocess import ListMultiProcessor

        out = ListMultiProcessor([1, 2, 3], _square, num_processes=1).process()
        assert out == [1, 4, 9]

    def test_list_processor_parallel(self):
        from tpu3drecon.utils.multiprocess import ListMultiProcessor

        items = list(range(40))
        out = ListMultiProcessor(items, _square, num_processes=2).process()
        assert out == [x * x for x in items]


def _square(x):
    return x * x


class TestOutputGrabber:
    def test_captures_fd_level_writes(self, capfd):
        import os
        import sys

        from tpu3drecon.benchmark.adapters.output_grabber import OutputGrabber

        # pytest's capture replaces fd 1; disable it so the grabber dups the
        # real stream like it would under the benchmark drivers.
        with capfd.disabled():
            g = OutputGrabber(sys.stdout)
            with g:
                # Write at the fd level, like native code would.
                os.write(sys.stdout.fileno(), b"native-report-line\n")
        assert "native-report-line" in g.capturedtext


class TestCheckpointGridEngine:
    def test_chunked_solve_with_grid_solver(self, scene, tmp_path):
        from tpu3drecon.problems.grid import grid_from_flat
        from tpu3drecon.solvers.ba_grid import ba_solve_grid

        noisy = perturb_scene(scene, seed=93, point2d_noise=0.0)
        flat, _ = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float64)
        grid = grid_from_flat(flat)
        config = BAConfig(maxiter=10, gtol=1e-12, ftol=0.0, cg_rtol=1e-8)
        cams, pts, state = ba_solve_checkpointed(
            grid, config, str(tmp_path / "ckg"), chunk_iters=5,
            solver_fn=ba_solve_grid,
        )
        assert float(reprojection_rmse(flat, cams, pts)) < 1e-3


class TestCompatOracle:
    def test_cpu_residual_oracle(self, rng):
        from scipy.spatial.transform import Rotation

        from tpu3drecon import compat

        rot = Rotation.random(random_state=np.random.RandomState(2)).as_matrix()
        pose = np.c_[rot, [0.1, 0.2, 5.0]]
        pose44 = np.r_[pose, [[0, 0, 0, 1]]]
        k = np.array([[500.0, 0, 250], [0, 500.0, 250], [0, 0, 1]])
        pts = rng.normal(size=(10, 3)) + [0, 0, 2.0]
        hom = np.c_[pts, np.ones(10)]
        proj = (k @ (pose @ hom.T))
        obs = (proj[:2] / proj[2]).T
        res = compat.get_reprojection_residuals_cpu(
            pose44, hom, obs, k, np.ones(10, bool)
        )
        np.testing.assert_allclose(res, 0.0, atol=1e-12)


class TestPlacement:
    def test_commit_pytree_round_trip(self):
        import jax
        import jax.numpy as jnp

        from tpu3drecon.utils.placement import commit

        tree = {
            "np": np.arange(6, dtype=np.float32).reshape(2, 3),
            "jax": jnp.ones((4,)),
            "static": 3,
        }
        out = commit(tree)
        tgt = jax.devices()[0]
        assert out["jax"].sharding.device_set == {tgt}
        np.testing.assert_array_equal(np.asarray(out["np"]), tree["np"])
        assert out["static"] == 3
        # Idempotent: already-resident leaves pass through untouched.
        out2 = commit(out)
        assert out2["jax"] is out["jax"]


class TestProblemCache:
    def test_miss_then_hit_numpy_leaves(self, tmp_path):
        import jax.numpy as jnp

        from tpu3drecon.utils.problem_cache import cached_problem

        calls = []

        def build():
            calls.append(1)
            return {"a": jnp.arange(5, dtype=jnp.float32), "static": 7}

        out1 = cached_problem("k1_v1", build, cache_dir=tmp_path)
        out2 = cached_problem("k1_v1", build, cache_dir=tmp_path)
        assert len(calls) == 1  # second call served from disk
        assert isinstance(out1["a"], np.ndarray) and isinstance(out2["a"], np.ndarray)
        np.testing.assert_array_equal(out1["a"], out2["a"])
        assert out2["static"] == 7
        # Different key -> rebuild.
        cached_problem("k2_v1", build, cache_dir=tmp_path)
        assert len(calls) == 2

    def test_corrupt_entry_rebuilds(self, tmp_path):
        """A truncated/stale pickle must be dropped and rebuilt, not crash
        every consumer of the key."""
        import jax.numpy as jnp

        from tpu3drecon.utils.problem_cache import cached_problem

        calls = []

        def build():
            calls.append(1)
            return {"a": jnp.arange(3, dtype=jnp.float32)}

        cached_problem("kc_v1", build, cache_dir=tmp_path)
        (entry,) = list(tmp_path.glob("*.pkl"))
        entry.write_bytes(b"not a pickle")
        out = cached_problem("kc_v1", build, cache_dir=tmp_path)
        assert len(calls) == 2  # rebuilt
        np.testing.assert_array_equal(out["a"], np.arange(3, dtype=np.float32))
        # The rebuilt entry serves hits again.
        cached_problem("kc_v1", lambda: 1 / 0, cache_dir=tmp_path)

    def test_wtt_problem_round_trips(self, tmp_path):
        """The BAL-scale use case: a full wtt pytree (nested dataclasses,
        static metadata, deferred one-hots) must survive the numpy-pickle
        round trip bit-exactly and still solve after placement."""
        import jax.numpy as jnp

        from tpu3drecon.dataset.synthetic import (
            make_sequential_scene,
            perturb_scene,
            scene_to_ba_problem,
        )
        from tpu3drecon.problems.wtt import expand_onehots, wtt_from_flat
        from tpu3drecon.solvers.ba_wtt import make_wtt_ba_solver
        from tpu3drecon.solvers.bundle_adjust import BAConfig
        from tpu3drecon.utils.placement import commit
        from tpu3drecon.utils.problem_cache import cached_problem

        scene = make_sequential_scene(n_cameras=12, points_per_camera=40,
                                      track_span=3, seed=5)
        noisy = perturb_scene(scene, seed=6, point2d_noise=0.3)
        flat, _ = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float32)

        def build():
            return wtt_from_flat(flat, point_chunk=16, defer_onehot=True)

        direct = build()
        cached_problem("wtt_rt_v1", build, cache_dir=tmp_path)
        loaded = cached_problem("wtt_rt_v1", lambda: 1 / 0, cache_dir=tmp_path)

        import jax

        for a, b in zip(jax.tree_util.tree_leaves(direct),
                        jax.tree_util.tree_leaves(loaded)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

        cfg = BAConfig(maxiter=3, gtol=0.0, ftol=0.0, cg_maxiter=5)
        solver = make_wtt_ba_solver(cfg)
        _, _, st_direct = solver(expand_onehots(commit(direct)))
        _, _, st_loaded = solver(expand_onehots(commit(loaded)))
        assert float(st_direct.loss) == float(st_loaded.loss)
