"""End-to-end benchmark-harness tests: adapters, persistence, drivers, plots.

The cross-framework parity run IS the integration test (the reference's own
strategy, SURVEY.md §4): this package's solver vs scipy baseline on the same noised
synthetic dataset must agree on final reprojection quality.
"""

import os

import numpy as np
import pytest

from tpu3drecon.benchmark.adapters.scipy_adapter import (
    ScipyBundleAdjustmentBenchmark,
    ScipySinglePoseBenchmark,
)
from tpu3drecon.benchmark.adapters.recon_adapters import (
    ReconBundleAdjustmentBenchmark,
    ReconSinglePoseBenchmark,
)
from tpu3drecon.benchmark.datasets import available, get_dataset
from tpu3drecon.benchmark.drivers import mean_reprojection_errors
from tpu3drecon.benchmark.harness import Benchmark, load_benchmarks, save_benchmarks


@pytest.fixture(scope="module")
def noised_dataset():
    return get_dataset("synthetic_small_noised")


@pytest.fixture(scope="module")
def recon_ba(noised_dataset):
    import jax.numpy as jnp

    b = ReconBundleAdjustmentBenchmark(noised_dataset, dtype=jnp.float64)
    b.benchmark()
    return b


@pytest.fixture(scope="module")
def scipy_ba(noised_dataset):
    b = ScipyBundleAdjustmentBenchmark(noised_dataset)
    b.benchmark(maxiter=60)
    return b


class TestRegistry:
    def test_synthetic_always_available(self):
        names = available()
        assert "synthetic_small" in names
        assert "synthetic_small_noised" in names

    def test_disk_gated_not_listed(self):
        # IMW2020 scenes aren't on disk in this environment.
        assert "reichstag" not in available()
        assert "reichstag" in available(include_disk_gated=True)

    def test_unknown_raises(self):
        with pytest.raises(KeyError):
            get_dataset("nope")


class TestReconBundleAdjustment:
    def test_improves_reprojection(self, noised_dataset, recon_ba):
        before = noised_dataset.compute_reprojection_errors_alt(lambda x: x)
        after = recon_ba.reprojection_errors()
        mean_before = np.mean(np.concatenate(list(before.values())))
        mean_after = np.mean(np.concatenate(list(after.values())))
        assert mean_after < 0.01 * mean_before

    def test_timing_split_recorded(self, recon_ba):
        assert recon_ba.time is not None and recon_ba.time > 0
        assert recon_ba.compile_time is not None
        assert recon_ba.iterations and recon_ba.iterations[0] > 0

    def test_parity_with_scipy(self, recon_ba, scipy_ba):
        recon_means = np.array(list(mean_reprojection_errors(recon_ba).values()))
        scipy_means = np.array(list(mean_reprojection_errors(scipy_ba).values()))
        # Both should land at sub-pixel^2 mean error; neither wildly worse.
        assert np.nanmean(recon_means) < 1.0
        assert np.nanmean(scipy_means) < 1.0


class TestReconSinglePose:
    def test_single_pose_benchmark(self):
        # Pose-only noise: points stay at GT so PnP has an exact optimum.
        from tpu3drecon.dataset.scene import Dataset

        ds = get_dataset("synthetic_small")
        # NOTE: camera_intrinsics_noise also perturbs cx/cy/skew, which the
        # PnP model freezes (like the reference) — that would leave an
        # irreducible residual floor, so perturb only pose here.
        noisy = Dataset.with_noise(
            ds, point3d_noise=0.0, point2d_noise=0.0,
            camera_rotation_noise=2e-2, camera_translation_noise=5e-2,
            camera_intrinsics_noise=0.0, rng=np.random.default_rng(7),
        )
        b = ReconSinglePoseBenchmark(noisy)
        b.benchmark(maxiter=100)
        means = mean_reprojection_errors(b)
        assert np.nanmean(list(means.values())) < 1e-3
        assert len(b.results.camera_mapping) == len(noisy.datasetEntries)
        assert len(b.iterations) == len(noisy.datasetEntries)

    def test_scipy_single_pose_parity(self):
        from tpu3drecon.dataset.scene import Dataset

        ds = get_dataset("synthetic_small")
        noisy = Dataset.with_noise(
            ds, point3d_noise=0.0, point2d_noise=0.0,
            camera_rotation_noise=2e-2, camera_translation_noise=5e-2,
            camera_intrinsics_noise=0.0, rng=np.random.default_rng(7),
        )
        b = ScipySinglePoseBenchmark(noisy)
        b.benchmark()
        means = mean_reprojection_errors(b)
        assert np.nanmean(list(means.values())) < 1e-3


class TestPersistence:
    def test_save_load_round_trip(self, recon_ba, tmp_path):
        out = save_benchmarks([recon_ba], str(tmp_path))
        assert os.path.isdir(os.path.join(tmp_path, "latest"))
        loaded = load_benchmarks(out)
        assert len(loaded) == 1
        lb = loaded[0]
        assert lb.time == recon_ba.time
        errs = lb.reprojection_errors()  # re-materialization works post-pickle
        assert len(errs) == len(recon_ba.dataset.datasetEntries)

    def test_export_results_colmap(self, recon_ba, tmp_path):
        out = tmp_path / "colmap_export"
        recon_ba.export_results_in_colmap_format(str(out), binary=True)
        from tpu3drecon.io import colmap as cio

        model = cio.read_model(str(out))
        assert len(model.images) == len(recon_ba.dataset.datasetEntries)


class TestSubprocessIsolation:
    def test_subprocess_benchmark(self, noised_dataset):
        import jax.numpy as jnp

        # Generous timeout: the spawned child recompiles from scratch.
        b = ReconBundleAdjustmentBenchmark(noised_dataset, dtype=jnp.float64)
        b.subprocess_benchmark(timeout_s=1800)
        assert b.time is not None
        assert len(b.results.camera_mapping) == len(noised_dataset.datasetEntries)


class TestReporting:
    def test_plots_render(self, recon_ba, scipy_ba, tmp_path, monkeypatch):
        import tpu3drecon.benchmark.reporting as rep

        monkeypatch.setattr(rep, "EVALUATION_PATH", str(tmp_path))
        paths = rep.bundle_adjustment_statistics([recon_ba, scipy_ba], "synthetic_small_noised")
        assert all(os.path.exists(p) for p in paths)
        assert len(paths) == 3


class TestDrivers:
    def test_ba_driver_cross_framework(self, tmp_path, monkeypatch):
        # The full driver path: ours + scipy on one dataset, with persistence.
        import tpu3drecon.benchmark.drivers as drv

        ds = get_dataset("synthetic_small_noised")
        benchmarks = drv.benchmark_bundle_adjustment(
            ds,
            with_colmap_baseline=False,  # not installed here
            with_gtsam_baseline=False,
            save=True,
            results_root=str(tmp_path),
        )
        assert len(benchmarks) == 2  # ours + scipy
        assert os.path.isdir(os.path.join(tmp_path, "latest"))
        for b in benchmarks:
            means = drv.mean_reprojection_errors(b)
            assert np.isfinite(np.nanmean(list(means.values())))

    def test_cost_curve_plot(self, tmp_path, monkeypatch):
        import jax.numpy as jnp

        import tpu3drecon.benchmark.reporting as rep
        from tpu3drecon.problems.from_dataset import pose_problem_from_dataset
        from tpu3drecon.solvers.pose_refine import pose_params_pack, refine_poses
        from tpu3drecon.solvers.lm_core import LMConfig

        monkeypatch.setattr(rep, "EVALUATION_PATH", str(tmp_path))
        ds = get_dataset("synthetic_small_noised")
        problem, _ = pose_problem_from_dataset(ds, dtype=jnp.float64)
        p0 = pose_params_pack(problem.cameras)
        cams, _ = refine_poses(problem, config=LMConfig(maxiter=30))
        p1 = pose_params_pack(cams)
        path = rep.plot_pose_cost_curve(problem, 0, np.array(p0[0]), np.array(p1[0]))
        assert os.path.exists(path)

    def test_reduced_ids_helper(self):
        ds = get_dataset("synthetic_small")
        ids = ds.get_reduced_dataset_2d_ids_per_camera(3, 50)
        assert set(ids.keys()) == {0, 1, 2}
        as_list = ds.get_reduced_dataset_2d_ids_per_camera(3, 50, as_list=True)
        assert len(as_list) == 3


class _NoJaxBenchmark(Benchmark):
    """A benchmark whose work touches no jax backend."""

    NAME = "nojax"

    def benchmark(self, **kwargs):
        self.results = {"ok": True}
        self.time = 0.0
        self.single_times = []
        self.iterations = []


class TestParentStaysOffBackend:
    def test_subprocess_benchmark_leaves_backend_alone(self, monkeypatch):
        """The parent must not initialize a jax backend before it spawns
        the child: on a card, the parent would take most of its memory and
        the child would fail to allocate.  The child gets the parent's
        configured platform, read from config alone."""
        import queue

        import jax

        from tpu3drecon.benchmark import harness

        def touched(*a, **k):
            raise AssertionError("parent initialized a jax backend")

        for name in ("default_backend", "devices", "local_devices"):
            monkeypatch.setattr(jax, name, touched)
        spawned = []

        class _Ctx:
            def Queue(self):
                return queue.Queue()

            def Process(self, target, args):
                spawned.append(args)

                class _P:
                    exitcode = 0

                    def start(self):
                        target(*args)

                    def is_alive(self):
                        return False

                    def join(self, timeout=None):
                        pass

                return _P()

        monkeypatch.setattr(harness.multiprocessing, "get_context",
                            lambda method: _Ctx())
        b = _NoJaxBenchmark(None)
        b.subprocess_benchmark(timeout_s=30)
        assert b.results == {"ok": True}
        assert spawned[0][2] == jax.config.jax_platforms
