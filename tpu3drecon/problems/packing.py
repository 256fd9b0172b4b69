"""Packed, static-shape problem containers for the solvers.

The reference extracts per-camera Python lists from its object model and pads
them ad hoc inside each benchmark adapter (reference: src/benchmark/
jaxopt_benchmark/benchmark_pose_optimization.py:55-105 and
benchmark_bundle_adjustment.py:45-106).  Here packing is a first-class,
vectorized pass producing two struct-of-array containers:

  - ``PoseProblem``: B independent PnP refinement problems padded to a common
    (bucketed) max point count with 0/1 masks;
  - ``BAProblem``: one bundle-adjustment problem in *flat observation* (BAL)
    layout — parallel arrays (cam_idx, pt_idx, uv, mask) — the layout the
    segment-sum JtJ accumulation, the implicit Schur solve, and the mesh
    sharding all operate on directly.

Both are registered pytrees (arrays = leaves, metadata = static) so they can
cross jit/shard_map boundaries whole.  Shapes are bucketed (rounded up to a
multiple) so repeated solves of similar-size problems hit the jit cache, the
generalization of the reference's compile-once accounting
(benchmark_pose_optimization.py:231-233).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu3drecon.geometry.rotations import quat_to_matrix_batch
from tpu3drecon.io.colmap.records import ColmapModel


def bucket_size(n: int, multiple: int = 256) -> int:
    """Round n up to a shape bucket (>= 1 multiple)."""
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class CameraParams:
    """Packed per-camera parameters (W2C extrinsics + intrinsics).

    ``dist = (k1, k2)`` is the polynomial radial distortion on normalized
    coordinates (BAL convention; COLMAP SIMPLE_RADIAL maps to (k, 0)); it is
    frozen under optimization like cx/cy/skew.  Use
    ``zero_distortion(n, dtype)`` for pinhole cameras.
    """

    rmats: jax.Array  # (B, 3, 3)
    tvecs: jax.Array  # (B, 3)
    fx_fy: jax.Array  # (B, 2)
    cx_cy_skew: jax.Array  # (B, 3) frozen under optimization
    dist: jax.Array  # (B, 2) frozen radial distortion (k1, k2)

    @property
    def n_cameras(self) -> int:
        return self.rmats.shape[0]


def zero_distortion(n: int, dtype=jnp.float32) -> jax.Array:
    """(n, 2) zero radial-distortion rows for pinhole cameras."""
    return jnp.zeros((n, 2), dtype)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PoseProblem:
    """B independent single-camera pose-refinement problems (padded).

    Counterpart of the reference's batched single-pose setup
    (benchmark_pose_optimization.py:86-130): fixed 3D points + observations
    per camera, pad-to-max with masks, avg-width normalization.
    """

    cameras: CameraParams
    points3d: jax.Array  # (B, N, 3) fixed 3D points per camera
    points2d: jax.Array  # (B, N, 2) observations
    mask: jax.Array  # (B, N) 1.0 = real observation
    avg_cam_width: jax.Array  # () residual normalizer (reference uses width^2)

    @property
    def batch(self) -> int:
        return self.points3d.shape[0]

    @property
    def max_points(self) -> int:
        return self.points3d.shape[1]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BAProblem:
    """One bundle-adjustment problem in flat-observation (BAL) layout."""

    cameras: CameraParams
    points3d: jax.Array  # (P, 3)
    cam_idx: jax.Array  # (N_obs,) int32 row into cameras
    pt_idx: jax.Array  # (N_obs,) int32 row into points3d
    uv: jax.Array  # (N_obs, 2) observations
    mask: jax.Array  # (N_obs,) 1.0 = real observation
    avg_cam_width: jax.Array  # ()

    @property
    def n_cameras(self) -> int:
        return self.cameras.rmats.shape[0]

    @property
    def n_points(self) -> int:
        return self.points3d.shape[0]

    @property
    def n_obs(self) -> int:
        return self.uv.shape[0]


@dataclass(frozen=True)
class ProblemMeta:
    """Host-side bookkeeping for round-tripping solver output back to model
    ids (NOT part of the pytree — never crosses into jit, so big id arrays
    don't poison the jit cache)."""

    camera_ids: np.ndarray  # COLMAP image ids per packed camera row
    point_ids: np.ndarray  # COLMAP point3D ids per packed point row
    widths: np.ndarray
    n_real_obs: int = 0
    distortion: Optional[np.ndarray] = None  # per-camera radial coeffs (BAL)


def _camera_arrays_from_model(
    model: ColmapModel, image_rows: np.ndarray, dtype
) -> Tuple[CameraParams, np.ndarray, np.ndarray]:
    """Extract packed camera params (+ widths, ids) for given image rows."""
    qvecs = np.asarray(model.images.qvecs)[image_rows]
    tvecs = np.asarray(model.images.tvecs)[image_rows]
    intr = np.zeros((len(image_rows), 5))
    dist = np.zeros((len(image_rows), 2))
    widths = np.zeros(len(image_rows))
    for k, row in enumerate(image_rows):
        cam = model.cameras[int(model.images.camera_ids[row])]
        intr[k] = cam.intrinsics_tuple()
        # SIMPLE_RADIAL's k maps to (k, 0); RADIAL gives (k1, k2) — both are
        # the same polynomial on normalized coords the solver applies
        # (reference loader.py:32-41 ingests SIMPLE_RADIAL the same way).
        d = cam.distortion_params()
        dist[k, : min(2, len(d))] = d[:2]
        widths[k] = cam.width
    rmats = quat_to_matrix_batch(jnp.asarray(qvecs, dtype))
    cameras = CameraParams(
        rmats=rmats,
        tvecs=jnp.asarray(tvecs, dtype),
        fx_fy=jnp.asarray(intr[:, :2], dtype),
        cx_cy_skew=jnp.asarray(intr[:, 2:], dtype),
        dist=jnp.asarray(dist, dtype),
    )
    return cameras, widths, np.asarray(model.images.image_ids)[image_rows]


def _searchsorted_hits(
    sorted_ids: np.ndarray, ids: np.ndarray, pos: np.ndarray
) -> np.ndarray:
    """Mask of ids actually present in sorted_ids (pos = searchsorted result).

    np.searchsorted alone maps a missing id to a *neighboring* row (or one
    past the end), silently corrupting the packed problem; callers must drop
    or reject the misses.
    """
    if len(sorted_ids) == 0:
        return np.zeros(len(ids), dtype=bool)
    return (pos < len(sorted_ids)) & (
        sorted_ids[np.minimum(pos, len(sorted_ids) - 1)] == ids
    )


def pose_problem_from_colmap(
    model: ColmapModel,
    camera_limit: Optional[int] = None,
    dtype=jnp.float32,
    pad_multiple: int = 256,
) -> Tuple[PoseProblem, ProblemMeta]:
    """Pack per-image PnP problems from a COLMAP model (vectorized).

    Replaces the reference's per-camera Python extraction + padding loops
    (benchmark_pose_optimization.py:55-105) with CSR slicing.
    """
    n_images = len(model.images)
    rows = np.arange(n_images if camera_limit is None else min(camera_limit, n_images))

    cameras, widths, image_ids = _camera_arrays_from_model(model, rows, dtype)

    sorted_pids = np.asarray(model.points.ids)
    order = np.argsort(sorted_pids)
    sorted_ids = sorted_pids[order]
    xyz_sorted = np.asarray(model.points.xyz)[order]

    per_cam_xy = []
    per_cam_xyz = []
    for row in rows:
        xy, p3d_ids = model.images.points2d_of(int(row))
        sel = p3d_ids >= 0
        xy = xy[sel]
        pid = p3d_ids[sel]
        pos = np.searchsorted(sorted_ids, pid)
        # An observation may reference a point3D id absent from points3D.bin
        # (corrupt or partially-filtered model); searchsorted would silently
        # map it to a neighboring point. Drop such observations instead.
        matched = _searchsorted_hits(sorted_ids, pid, pos)
        per_cam_xy.append(xy[matched])
        per_cam_xyz.append(xyz_sorted[pos[matched]])

    max_n = bucket_size(max((len(x) for x in per_cam_xy), default=1), pad_multiple)
    B = len(rows)
    pts3 = np.zeros((B, max_n, 3))
    pts2 = np.zeros((B, max_n, 2))
    mask = np.zeros((B, max_n))
    for k in range(B):
        n = len(per_cam_xy[k])
        pts2[k, :n] = per_cam_xy[k]
        pts3[k, :n] = per_cam_xyz[k]
        mask[k, :n] = 1.0

    problem = PoseProblem(
        cameras=cameras,
        points3d=jnp.asarray(pts3, dtype),
        points2d=jnp.asarray(pts2, dtype),
        mask=jnp.asarray(mask, dtype),
        avg_cam_width=jnp.asarray(float(np.mean(widths)), dtype),
    )
    meta = ProblemMeta(
        camera_ids=image_ids,
        point_ids=np.zeros(0, np.int64),
        widths=widths,
        n_real_obs=int(sum(len(x) for x in per_cam_xy)),
    )
    return problem, meta


def ba_problem_from_colmap(
    model: ColmapModel,
    camera_limit: Optional[int] = None,
    points_per_camera_limit: Optional[int] = None,
    min_track_len: int = 2,
    dtype=jnp.float32,
    pad_multiple: int = 1024,
) -> Tuple[BAProblem, ProblemMeta]:
    """Pack a flat-observation BA problem from a COLMAP model.

    One vectorized pass reproducing the semantics of the reference's
    ``make_reduced_dataset`` + adapter packing (dataset.py:172-201,
    benchmark_bundle_adjustment.py:45-106): optional camera/points-per-camera
    caps, keep only 3D points observed >= ``min_track_len`` times among the
    selected observations, global point index table sorted by point id.
    """
    n_images = len(model.images)
    rows = np.arange(n_images if camera_limit is None else min(camera_limit, n_images))

    cameras, widths, image_ids = _camera_arrays_from_model(model, rows, dtype)

    # Gather candidate observations (vectorized over the CSR layout).
    cam_idx_chunks, xy_chunks, pid_chunks = [], [], []
    for k, row in enumerate(rows):
        xy, p3d_ids = model.images.points2d_of(int(row))
        sel = np.nonzero(p3d_ids >= 0)[0]
        if points_per_camera_limit is not None:
            sel = sel[:points_per_camera_limit]
        cam_idx_chunks.append(np.full(len(sel), k, np.int32))
        xy_chunks.append(xy[sel])
        pid_chunks.append(p3d_ids[sel])
    cam_idx = np.concatenate(cam_idx_chunks) if cam_idx_chunks else np.zeros(0, np.int32)
    uv = np.concatenate(xy_chunks) if xy_chunks else np.zeros((0, 2))
    pids = np.concatenate(pid_chunks) if pid_chunks else np.zeros(0, np.int64)

    # Drop observations referencing point3D ids absent from points3D.bin
    # (corrupt/partially-filtered model) before any index math.
    all_sorted = np.sort(np.asarray(model.points.ids))
    present = _searchsorted_hits(all_sorted, pids, np.searchsorted(all_sorted, pids))
    cam_idx, uv, pids = cam_idx[present], uv[present], pids[present]

    # Keep points with sufficient track length among selected obs.
    uniq, inverse, counts = np.unique(pids, return_inverse=True, return_counts=True)
    keep_point = counts >= min_track_len
    keep_obs = keep_point[inverse]
    cam_idx, uv, pids = cam_idx[keep_obs], uv[keep_obs], pids[keep_obs]

    # Global point table sorted by id (reference benchmark_bundle_adjustment.py:67-71).
    kept_ids = uniq[keep_point]
    pt_idx = np.searchsorted(kept_ids, pids).astype(np.int32)

    order = np.argsort(np.asarray(model.points.ids))
    xyz_rows = np.asarray(model.points.xyz)[order][np.searchsorted(all_sorted, kept_ids)]

    n_obs = len(cam_idx)
    n_pad = bucket_size(max(n_obs, 1), pad_multiple)
    pad = n_pad - n_obs
    # Padding rows point at camera 0 / point 0 with mask 0: they contribute
    # exact zeros to residuals, gradients and JtJ blocks.
    cam_idx = np.concatenate([cam_idx, np.zeros(pad, np.int32)])
    pt_idx = np.concatenate([pt_idx, np.zeros(pad, np.int32)])
    uv = np.concatenate([uv, np.zeros((pad, 2))])
    mask = np.concatenate([np.ones(n_obs), np.zeros(pad)])

    problem = BAProblem(
        cameras=cameras,
        points3d=jnp.asarray(xyz_rows, dtype),
        cam_idx=jnp.asarray(cam_idx),
        pt_idx=jnp.asarray(pt_idx),
        uv=jnp.asarray(uv, dtype),
        mask=jnp.asarray(mask, dtype),
        avg_cam_width=jnp.asarray(float(np.mean(widths)), dtype),
    )
    meta = ProblemMeta(
        camera_ids=image_ids,
        point_ids=kept_ids,
        widths=widths,
        n_real_obs=n_obs,
    )
    return problem, meta


def colmap_model_with_solution(
    model: ColmapModel,
    cameras: CameraParams,
    points3d,
    meta: ProblemMeta,
) -> ColmapModel:
    """Write a BA solution back into a COLMAP model (new model, input
    untouched).

    Inverse of ``ba_problem_from_colmap``: packed camera rows map to image
    ids via ``meta.camera_ids``, packed point rows to point3D ids via
    ``meta.point_ids``; images/points the problem didn't cover keep their
    original values.  Pose conversion runs in host float64 (device-side
    conversions truncate to f32 — see io/bal.py).
    """
    import dataclasses

    import jax

    from tpu3drecon.geometry.rotations import matrix_to_quat_batch

    rmats = np.asarray(jax.device_get(cameras.rmats), np.float64)
    tvecs = np.asarray(jax.device_get(cameras.tvecs), np.float64)
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        import jax.numpy as jnp

        qvecs_new = np.asarray(matrix_to_quat_batch(jnp.asarray(rmats)))

    image_ids = np.asarray(model.images.image_ids)
    row_of_image = {int(i): r for r, i in enumerate(image_ids)}
    qvecs = np.asarray(model.images.qvecs).copy()
    tvecs_out = np.asarray(model.images.tvecs).copy()
    fx_fy = np.asarray(jax.device_get(cameras.fx_fy), np.float64)
    new_cameras = dict(model.cameras)
    for packed_row, image_id in enumerate(np.asarray(meta.camera_ids)):
        r = row_of_image.get(int(image_id))
        if r is None:
            continue
        qvecs[r] = qvecs_new[packed_row]
        tvecs_out[r] = tvecs[packed_row]
        # Solved focal lengths go back into the (possibly shared) camera
        # record; with shared cameras the last packed row wins.
        cam_id = int(model.images.camera_ids[r])
        cam = new_cameras[cam_id]
        params = np.asarray(cam.params, np.float64).copy()
        from tpu3drecon.io.colmap.records import CameraModelType

        if cam.model in (CameraModelType.PINHOLE, CameraModelType.OPENCV):
            params[0:2] = fx_fy[packed_row]
        else:  # single-focal families (SIMPLE_PINHOLE, SIMPLE_RADIAL, ...)
            params[0] = fx_fy[packed_row, 0]
        new_cameras[cam_id] = dataclasses.replace(cam, params=params)

    xyz = np.asarray(model.points.xyz).copy()
    pts = np.asarray(jax.device_get(points3d), np.float64)
    if len(meta.point_ids):
        rows = np.asarray(
            [model.point_row_of_id(int(pid)) for pid in np.asarray(meta.point_ids)]
        )
        xyz[rows] = pts[: len(rows)]

    return dataclasses.replace(
        model,
        cameras=new_cameras,
        images=dataclasses.replace(model.images, qvecs=qvecs, tvecs=tvecs_out),
        points=dataclasses.replace(model.points, xyz=xyz),
    )
