"""Grid-layout BA problem: the scatter-free layout.

The flat observation list (BAProblem) accumulates JtJ blocks with
``segment_sum`` — which XLA lowers to scatter-adds.  This layout removes
every scatter from the hot loop:

  - observations live on a dense (C, K) grid (camera-major, padded to K
    observations per camera with masks), so all *per-camera* reductions
    (U blocks, gradients, W-matvec halves) are batched matmuls with the K
    axis as the contraction — matmuls with perfect static shapes;
  - a (P, T) *track table* indexes each point's observations in the
    flattened C*K space, so all *per-point* reductions (V blocks, gradients,
    W^T-matvec halves) are gathers followed by dense reductions over T.

Padding invariants: padded grid cells carry mask 0 (their whitened blocks
are exact zeros); padded track entries point at flat index 0 and carry their
own 0 in ``track_mask`` (flat cell 0 can be a real observation of another
point, so the track mask is load-bearing).

This is the same restructuring 3DGS-LM/PBA-class systems use for GPU BA
(see PAPERS.md).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu3drecon.problems.packing import BAProblem, CameraParams, bucket_size


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class TrackBucket:
    """One track-length bucket: points whose tracks fit in T slots."""

    track_idx: jax.Array  # (Pb, T) int32 into flat C*K
    track_cam: jax.Array  # (Pb, T) int32
    track_mask: jax.Array  # (Pb, T)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BAGridBucketedProblem:
    """Grid-layout BA problem with track-length-bucketed point tables.

    The single (P, T_max) track table wastes gathers badly when the track
    distribution is skewed (mean ~2, max ~16 on photo-tourism-like data: 87%
    of gathered rows are padding).  Here points are PERMUTED so same-bucket
    points are contiguous, each bucket has a tight T, and the point axis is
    padded per bucket to the point-kernel block size.  ``pt_idx`` on the
    camera grid is relabeled to the permuted order; ``point_rows`` maps
    permuted rows back to the original point rows (use it to un-permute
    solver output).
    """

    cameras: CameraParams
    points3d: jax.Array  # (P_pad, 3) permuted + padded
    uv: jax.Array  # (C, K, 2)
    pt_idx: jax.Array  # (C, K) int32 into permuted points
    mask: jax.Array  # (C, K)
    buckets: Tuple[TrackBucket, ...]
    avg_cam_width: jax.Array  # ()
    # point_rows is data (int32 array): original row of each permuted row
    # (-1 for padding rows).
    point_rows: jax.Array = None
    # Static metadata (hashable for jit caching).
    n_real_points: int = dataclasses.field(default=0, metadata=dict(static=True))

    @property
    def n_cameras(self) -> int:
        return self.uv.shape[0]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BAGridProblem:
    """BA problem in camera-grid + track-table layout."""

    cameras: CameraParams
    points3d: jax.Array  # (P, 3)
    uv: jax.Array  # (C, K, 2)
    pt_idx: jax.Array  # (C, K) int32
    mask: jax.Array  # (C, K)
    track_idx: jax.Array  # (P, T) int32 into flat C*K
    track_cam: jax.Array  # (P, T) int32 camera row of each track entry
    track_mask: jax.Array  # (P, T)
    avg_cam_width: jax.Array  # ()

    @property
    def n_cameras(self) -> int:
        return self.uv.shape[0]

    @property
    def obs_per_camera(self) -> int:
        return self.uv.shape[1]

    @property
    def n_points(self) -> int:
        return self.points3d.shape[0]

    @property
    def max_track(self) -> int:
        return self.track_idx.shape[1]


def grid_from_flat(
    problem: BAProblem,
    obs_pad_multiple: int = 128,
    track_pad_multiple: int = 8,
) -> BAGridProblem:
    """Repack a flat BAProblem into the grid layout (host-side, vectorized).

    The pad multiples follow the first accelerator's (8, 128) tiling; they
    are correct anywhere and not yet retuned for the H100."""
    # One bulk host transfer instead of one pull per array.
    problem = jax.device_get(problem)
    cam_idx = np.asarray(problem.cam_idx)
    pt_idx = np.asarray(problem.pt_idx)
    uv = np.asarray(problem.uv)
    mask = np.asarray(problem.mask)
    real = mask > 0
    cam_idx, pt_idx, uv = cam_idx[real], pt_idx[real], uv[real]

    C = problem.n_cameras
    P = problem.n_points
    counts = np.bincount(cam_idx, minlength=C)
    K = bucket_size(max(int(counts.max()), 1), obs_pad_multiple)

    order = np.argsort(cam_idx, kind="stable")
    cam_sorted = cam_idx[order]
    pt_sorted = pt_idx[order]
    uv_sorted = uv[order]
    starts = np.zeros(C + 1, np.int64)
    np.cumsum(counts, out=starts[1:])

    guv = np.zeros((C, K, 2), uv.dtype)
    gpt = np.zeros((C, K), np.int32)
    gmask = np.zeros((C, K), uv.dtype)
    # Row positions of each sorted obs within its camera row.
    local = np.arange(len(cam_sorted)) - starts[cam_sorted]
    guv[cam_sorted, local] = uv_sorted
    gpt[cam_sorted, local] = pt_sorted
    gmask[cam_sorted, local] = 1.0

    # Track table: flat indices (c * K + k) of each point's observations.
    flat_of_sorted = cam_sorted.astype(np.int64) * K + local
    porder = np.argsort(pt_sorted, kind="stable")
    p_of = pt_sorted[porder]
    flat_of = flat_of_sorted[porder]
    pcounts = np.bincount(p_of, minlength=P)
    T = bucket_size(max(int(pcounts.max()), 1), track_pad_multiple)
    pstarts = np.zeros(P + 1, np.int64)
    np.cumsum(pcounts, out=pstarts[1:])
    plocal = np.arange(len(p_of)) - pstarts[p_of]
    tidx = np.zeros((P, T), np.int32)
    tcam = np.zeros((P, T), np.int32)
    tmask = np.zeros((P, T), uv.dtype)
    tidx[p_of, plocal] = flat_of.astype(np.int32)
    tcam[p_of, plocal] = cam_sorted[porder].astype(np.int32)
    tmask[p_of, plocal] = 1.0

    dtype = problem.uv.dtype
    return BAGridProblem(
        cameras=problem.cameras,
        points3d=problem.points3d,
        uv=jnp.asarray(guv, dtype),
        pt_idx=jnp.asarray(gpt),
        mask=jnp.asarray(gmask, dtype),
        track_idx=jnp.asarray(tidx),
        track_cam=jnp.asarray(tcam),
        track_mask=jnp.asarray(tmask, dtype),
        avg_cam_width=problem.avg_cam_width,
    )


def grid_bucketed_from_flat(
    problem: BAProblem,
    obs_pad_multiple: int = 128,
    bounds: Tuple[int, ...] = (2, 3, 4, 8),
    point_block: int = 512,
    small_track: Optional[int] = None,
    order_points_by_cam: bool = False,
) -> BAGridBucketedProblem:
    """Repack a flat BAProblem into the bucketed grid layout.

    ``bounds = (b1, b2, ...)`` splits points by track length into buckets
    (len <= b1), (b1 < len <= b2), ..., (> b_last, T = max length rounded to
    4).  Gathered padding rows cost like real ones, so tight buckets
    directly cut the per-matvec and per-linearization gather work: on the
    medium bench problem a two-bucket scheme wasted 55% of gathered rows as
    padding; (2, 4, 8) wastes 26%.  Each bucket's point count is padded to
    ``point_block`` (keeps every bucket divisible by power-of-two meshes);
    padding rows have empty tracks and zero points.

    ``small_track`` is the deprecated round-1 single-boundary form.

    ``order_points_by_cam`` sorts each bucket's points by the minimum camera
    id observing them (stable).  Semantically neutral (any within-bucket
    point order is valid); it gives consecutive point chunks camera
    LOCALITY, which the windowed track-table layout (problems/wtt.py) turns
    into narrow per-chunk one-hot windows on sequential-capture datasets
    (BAL-style).
    """
    if small_track is not None:
        bounds = (small_track,)
    base = grid_from_flat(problem, obs_pad_multiple=obs_pad_multiple)
    gpt = np.asarray(base.pt_idx)
    tidx = np.asarray(base.track_idx)
    tcam = np.asarray(base.track_cam)
    tmask = np.asarray(base.track_mask)
    points = np.asarray(jax.device_get(base.points3d))
    P, T = tidx.shape

    lengths = tmask.sum(axis=1).astype(np.int64)
    max_len = max(int(lengths.max()), 1)
    # Bucket upper bounds: the configured boundaries (cropped to max_len),
    # plus a final bucket covering the tail.
    uppers = [b for b in sorted(bounds) if b < max_len]
    uppers.append(bucket_size(max_len, 4) if uppers else bucket_size(max_len, 4))
    row_groups = []
    lo = 0
    for t in uppers:
        sel = np.nonzero((lengths > lo) & (lengths <= t))[0]
        lo = t
        row_groups.append((sel, max(t, 1)))
    # Track-0 points (unobserved) fall in the first group via lengths > -1?
    # They have length 0 so match no (lo=0) group — put them in group 0 so
    # every point keeps a bucket row (unpermute_points requires it).
    zero_rows = np.nonzero(lengths == 0)[0]
    if len(zero_rows):
        sel0, t0 = row_groups[0]
        row_groups[0] = (np.sort(np.concatenate([sel0, zero_rows])), t0)

    if order_points_by_cam:
        min_cam = np.where(tmask > 0, tcam, np.iinfo(np.int32).max).min(axis=1)
        row_groups = [
            (rows[np.argsort(min_cam[rows], kind="stable")], t)
            for rows, t in row_groups
        ]

    def pad_to(n, m):
        return ((n + m - 1) // m) * m if n else 0

    offsets, kept_groups = [], []
    off = 0
    for rows, t in row_groups:
        if not len(rows):
            continue
        p_pad = pad_to(len(rows), point_block)
        offsets.append(off)
        kept_groups.append((rows, p_pad, t))
        off += p_pad

    # Permuted + padded point array: [g0 pts | g0 pad | g1 pts | g1 pad | ...]
    p_total = off
    new_points = np.zeros((p_total, 3), points.dtype)
    point_rows = np.full(p_total, -1, np.int64)
    old_to_new = np.zeros(P, np.int64)
    for (rows, p_pad, _t), start in zip(kept_groups, offsets):
        new_points[start : start + len(rows)] = points[rows]
        point_rows[start : start + len(rows)] = rows
        old_to_new[rows] = start + np.arange(len(rows))
    new_pt_idx = old_to_new[gpt].astype(np.int32)
    # Padded grid cells keep mask 0; their pt_idx points at row old_to_new[0].

    # Row-sort: order each camera row's observations by the FINAL point index
    # (padding cells last).  Semantically neutral (obs order within a row is
    # arbitrary).  In-context A/B measured this NEUTRAL for solve time (the
    # serial-microbench 25% sorted-gather win does not transfer: the solve's
    # gathers already pipeline) — kept because deterministic monotone access
    # patterns cost nothing and simplify reasoning about transports.
    guv = np.asarray(base.uv)
    gmask = np.asarray(base.mask)
    C, K = gmask.shape
    sort_key = np.where(gmask > 0, new_pt_idx, np.iinfo(np.int32).max)
    order = np.argsort(sort_key, axis=1, kind="stable")
    rowsel = np.arange(C)[:, None]
    guv = guv[rowsel, order]
    gmask = gmask[rowsel, order]
    new_pt_idx = new_pt_idx[rowsel, order]

    # Rebuild the track tables against the row-sorted layout + permuted
    # point rows (the base table indexes the pre-sort flat cells).
    real = gmask.reshape(-1) > 0
    flat_pos = np.nonzero(real)[0].astype(np.int64)  # camera-major order
    pids_new = new_pt_idx.reshape(-1)[real].astype(np.int64)
    cams_of = (flat_pos // K).astype(np.int32)
    porder = np.argsort(pids_new, kind="stable")
    p_of = pids_new[porder]
    flat_of = flat_pos[porder]
    cam_of = cams_of[porder]
    counts = np.bincount(p_of, minlength=p_total)
    pstarts = np.zeros(p_total + 1, np.int64)
    np.cumsum(counts, out=pstarts[1:])
    plocal = (np.arange(len(p_of)) - pstarts[p_of]).astype(np.int64)

    buckets = []
    for (rows, p_pad, t), start in zip(kept_groups, offsets):
        bi = np.zeros((p_pad, t), np.int32)
        bc = np.zeros((p_pad, t), np.int32)
        bm = np.zeros((p_pad, t), tmask.dtype)
        in_bucket = (p_of >= start) & (p_of < start + p_pad)
        pr = p_of[in_bucket] - start
        pl = plocal[in_bucket]
        bi[pr, pl] = flat_of[in_bucket].astype(np.int32)
        bc[pr, pl] = cam_of[in_bucket]
        bm[pr, pl] = 1.0
        buckets.append(
            TrackBucket(
                track_idx=jnp.asarray(bi),
                track_cam=jnp.asarray(bc),
                track_mask=jnp.asarray(bm),
            )
        )

    dtype = problem.uv.dtype
    return BAGridBucketedProblem(
        cameras=base.cameras,
        points3d=jnp.asarray(new_points, dtype),
        uv=jnp.asarray(guv, dtype),
        pt_idx=jnp.asarray(new_pt_idx),
        mask=jnp.asarray(gmask, dtype),
        buckets=tuple(buckets),
        avg_cam_width=base.avg_cam_width,
        point_rows=jnp.asarray(point_rows.astype(np.int32)),
        n_real_points=P,
    )


def unpermute_points(
    solved_points: jax.Array, problem: BAGridBucketedProblem
) -> jax.Array:
    """Map bucketed-solver point output back to the original point order."""
    rows = jnp.asarray(problem.point_rows)
    out = jnp.zeros((problem.n_real_points, solved_points.shape[1]), solved_points.dtype)
    valid = rows >= 0
    safe_rows = jnp.where(valid, rows, 0)
    # scatter-ADD with zeroed padding rows: every real row is written exactly
    # once; padding rows contribute 0 to row 0 (a .set could let a padding
    # write clobber the real row 0 nondeterministically).
    return out.at[safe_rows].add(solved_points * valid[:, None])
