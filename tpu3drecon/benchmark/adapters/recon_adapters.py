"""This package's solver adapters for the benchmark harness.

Counterparts of the reference's jaxopt adapters
(reference: src/benchmark/jaxopt_benchmark/benchmark_pose_optimization.py,
benchmark_bundle_adjustment.py, helpers.py): run the packed solvers on a
Dataset, keep the compile-vs-optimize timing split, guard against NaN output
(helpers.py:24-27,82-85), and re-materialize results into Camera/Point3D
objects with explicit host numpy conversion (so pickles never retain device
buffers — the reference's "GPU memory revival" note, helpers.py:20-21).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpu3drecon.benchmark.harness import (
    BundleAdjustmentBenchmark,
    BundleAdjustmentBenchmarkResults,
    SinglePoseBenchmark,
    SinglePoseBenchmarkResults,
)
from tpu3drecon.dataset.camera_pose import (
    CameraPose,
    CoordinateSystem,
    TransformationDirection,
)
from tpu3drecon.dataset.model import Camera, Point3D, params_to_intrinsics
from tpu3drecon.dataset.scene import Dataset
from tpu3drecon.geometry.losses import RobustLoss
from tpu3drecon.problems.from_dataset import (
    ba_problem_from_dataset,
    pose_problem_from_dataset,
)
from tpu3drecon.problems.packing import CameraParams
from tpu3drecon.solvers.bundle_adjust import BAConfig, ba_solve, make_ba_solver
from tpu3drecon.solvers.lm_core import LMConfig
from tpu3drecon.solvers.pose_refine import refine_poses


class NanGuardError(RuntimeError):
    """Solver diverged to NaN (reference helpers.py:24-27 raised ValueError)."""


def _check_finite(name: str, *arrays) -> None:
    for a in arrays:
        if not np.all(np.isfinite(np.asarray(a))):
            raise NanGuardError(f"{name}: non-finite values in solver output")


def _cameras_to_objects(
    cameras: CameraParams, dataset: Dataset
) -> Dict[int, Camera]:
    """Packed camera params -> {entry index: Camera} (reference
    helpers.py:19-53 / 56-129 parsing, vectorized + host-converted)."""
    rmats = np.asarray(jax.device_get(cameras.rmats), dtype=np.float64)
    tvecs = np.asarray(jax.device_get(cameras.tvecs), dtype=np.float64)
    fx_fy = np.asarray(jax.device_get(cameras.fx_fy), dtype=np.float64)
    ccs = np.asarray(jax.device_get(cameras.cx_cy_skew), dtype=np.float64)
    _check_finite("cameras", rmats, tvecs, fx_fy)
    out: Dict[int, Camera] = {}
    for i, entry in enumerate(dataset.datasetEntries):
        pose = CameraPose(
            rmats[i],
            tvecs[i],
            identifier=entry.camera.camera_pose.identifier,
            coordinate_system=CoordinateSystem.COLMAP,
            direction=TransformationDirection.W2C,
        )
        out[i] = Camera(
            camera_pose=pose,
            camera_intrinsics=params_to_intrinsics(
                fx_fy[i, 0], fx_fy[i, 1], ccs[i, 0], ccs[i, 1], ccs[i, 2] or None
            ),
            width=entry.camera.width,
            height=entry.camera.height,
        )
    return out


class ReconSinglePoseBenchmark(SinglePoseBenchmark):
    """Batched PnP refinement on the accelerator (analog of
    JaxoptSinglePoseBenchmarkBatched, benchmark_pose_optimization.py:14)."""

    FRAMEWORK = "tpu3drecon"
    NAME = "ReconSinglePoseBenchmark"

    def __init__(self, dataset: Dataset, loss: RobustLoss = RobustLoss.CAUCHY,
                 dtype=jnp.float32):
        super().__init__(dataset)
        self.loss = loss
        self.dtype = dtype
        self.compile_time: Optional[float] = None

    def benchmark(self, maxiter: int = 100, gtol: float = 1e-7, **_) -> None:
        problem, meta = pose_problem_from_dataset(self.dataset, dtype=self.dtype)
        config = LMConfig(maxiter=maxiter, gtol=gtol)

        t0 = time.perf_counter()
        cams, state = refine_poses(problem, loss=self.loss, config=config)
        jax.device_get(state.loss)
        first = time.perf_counter() - t0

        t0 = time.perf_counter()
        cams, state = refine_poses(problem, loss=self.loss, config=config)
        jax.device_get(state.loss)
        run = time.perf_counter() - t0

        self.compile_time = first - run
        self.time = run
        self.iterations = [int(i) for i in np.asarray(jax.device_get(state.iter_num))]
        self.single_times = [run / max(problem.batch, 1)] * problem.batch
        self.results = SinglePoseBenchmarkResults(
            camera_mapping=_cameras_to_objects(cams, self.dataset)
        )


class ReconBundleAdjustmentBenchmark(BundleAdjustmentBenchmark):
    """Implicit-Schur BA on the accelerator (analog of JaxoptBundleAdjustmentBenchmark,
    benchmark_bundle_adjustment.py:21 — without its 15-cam/400-pt cap)."""

    FRAMEWORK = "tpu3drecon"
    NAME = "ReconBundleAdjustmentBenchmark"

    def __init__(self, dataset: Dataset, dtype=jnp.float32):
        super().__init__(dataset)
        self.dtype = dtype
        self.compile_time: Optional[float] = None

    def benchmark(
        self,
        camera_limit: Optional[int] = None,
        points_limit: Optional[int] = None,
        config: Optional[BAConfig] = None,
        **_,
    ) -> None:
        ds = self.dataset
        if camera_limit is not None:
            ds = ds.make_reduced_dataset(camera_limit, points_limit or 10**9)
        problem, meta = ba_problem_from_dataset(ds, dtype=self.dtype)
        config = config or BAConfig(maxiter=100, gtol=1e-6 if self.dtype == jnp.float32 else 1e-10)
        solver = make_ba_solver(config)

        t0 = time.perf_counter()
        cams, pts, state = solver(problem)
        jax.device_get(state.loss)
        first = time.perf_counter() - t0

        t0 = time.perf_counter()
        cams, pts, state = solver(problem)
        jax.device_get(state.loss)
        run = time.perf_counter() - t0

        self.compile_time = first - run
        self.time = run
        self.iterations = [int(jax.device_get(state.iter_num))]

        pts_np = np.asarray(jax.device_get(pts), dtype=np.float64)
        _check_finite("points", pts_np)
        point_mapping = {
            int(pid): Point3D(
                int(pid), float(p[0]), float(p[1]), float(p[2]),
                dict(ds.points3D_mapped[int(pid)].metadata),
            )
            for pid, p in zip(meta.point_ids, pts_np)
        }
        self.results = BundleAdjustmentBenchmarkResults(
            camera_mapping=_cameras_to_objects(cams, ds),
            point_mapping=point_mapping,
        )
        # The reduced dataset is what results re-materialize against.
        self.dataset = ds
