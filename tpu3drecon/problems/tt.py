"""Track-table BA problem: the gather-free single-chip layout.

The grid engine's solve time is dominated by per-row transport between the
camera-major grid and the point-major track table (RESULTS.md, measured on
the accelerator this layout was first built for; not yet re-measured on the
H100).  This layout removes the transport entirely by making the *track
table the only observation layout*:

  - every observation lives in exactly one slot of a track-length-bucketed
    (T, P) table (point-major), so every *per-point* reduction (V blocks,
    gradients, W^T-matvec halves) is a dense sum over the T axis and every
    per-point broadcast is free;
  - every *per-camera* interaction — parameter lookup per slot, U/g_cam
    accumulation, both halves of the Schur coupling — contracts a tiny
    (C, d) camera table against a precomputed {0,1} one-hot matrix
    ``onehot[c, n] = mask[n] * [cam(n) == c]`` of shape (C, T*P).  A
    one-hot contraction is a matmul that streams its operands — there is no
    per-row gather at all;
  - every array is stored *plane-major* (component axes leading, the big
    slot axis last), so narrow trailing dims never pad a tiled layout.

The price is the dense one-hot matrix: C * (T*P) elements.  For the
benchmark scale (C=100, ~270k slots) that is ~107 MB — cheap against the
transport it removes.  It scales linearly in C, so this layout is for
moderate camera counts (the builder refuses above ``max_onehot_bytes``);
BAL-scale problems go to the windowed engine (problems/wtt.py) or the grid
engine, whose transport cost is amortized by sharding.

No reference counterpart: the reference's jaxopt BA materializes a dense
Jacobian (src/reconstruction/bundle_adjustment/bundle_adjustment.py:83-91)
and cannot run these sizes at all.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu3drecon.problems.grid import grid_bucketed_from_flat
from tpu3drecon.problems.packing import BAProblem, CameraParams


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class TTBucket:
    """One track-length bucket, plane-major (slot axis last).

    ``n = t * P_b + p`` flattens (T_b, P_b) row-major; ``onehot`` is indexed
    by that same flat order.  Single-chip problems store it FLAT (C, Tb*Pb)
    — the (C, n) and (C, Tb, Pb) forms can have different tiled layouts, so
    a per-use reshape of the biggest array in the problem may be a real
    copy.  The sharded placement
    (parallel/sharded_tt.shard_tt_problem) re-materializes it as
    (C, Tb, Pb) host-side so the point axis can carry a PartitionSpec; the
    engine accepts either form (solvers/ba_tt._flat_onehot).
    """

    uv: jax.Array  # (2, Tb, Pb) observed pixels
    mask: jax.Array  # (Tb, Pb) 1.0 = real observation
    cam_ids: jax.Array  # (Tb, Pb) int32 (0 on padding)
    onehot: jax.Array  # (C, Tb*Pb) {0,1} (or (C, Tb, Pb) when sharded), mask applied


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BATTProblem:
    """BA problem in bucketed track-table layout.

    Points are permuted into bucket-major order exactly like
    BAGridBucketedProblem (``point_rows`` maps back; use
    ``tpu3drecon.problems.grid.unpermute_points``).  ``bucket_offsets[b]`` is
    the first row of bucket b's points inside ``points3d``.
    """

    cameras: CameraParams
    points3d: jax.Array  # (P_total, 3) permuted + padded
    buckets: Tuple[TTBucket, ...]
    avg_cam_width: jax.Array  # ()
    point_rows: jax.Array = None  # (P_total,) original row or -1
    n_real_points: int = dataclasses.field(default=0, metadata=dict(static=True))
    bucket_offsets: Tuple[int, ...] = dataclasses.field(
        default=(), metadata=dict(static=True)
    )

    @property
    def n_cameras(self) -> int:
        return self.cameras.rmats.shape[0]


def tt_from_flat(
    problem: BAProblem,
    bounds: Tuple[int, ...] = (2, 3, 4, 8),
    point_block: int = 512,
    max_onehot_bytes: int = 2 << 30,
    onehot_dtype=None,
) -> BATTProblem:
    """Repack a flat BAProblem into the track-table layout (host-side).

    Reuses the bucketed-grid builder for the track bucketing/permutation, then
    derives per-slot observations and the one-hot camera matrices.  Raises
    ``ValueError`` when the one-hot matrices would exceed ``max_onehot_bytes``
    (large camera counts belong on the windowed engine, problems/wtt.py).

    ``onehot_dtype`` defaults to int8: {0,1} is exactly representable and
    the engine's mixed-precision contractions convert it back exactly, so
    the 1-byte encoding quarters the one-hot stream at no cost in accuracy.
    """
    g = grid_bucketed_from_flat(problem, bounds=bounds, point_block=point_block)
    guv = np.asarray(jax.device_get(g.uv))
    C, K = guv.shape[:2]
    uv_flat = guv.reshape(C * K, 2)
    np_dtype = uv_flat.dtype

    total_slots = sum(
        int(np.prod(np.asarray(jax.device_get(b.track_mask)).shape))
        for b in g.buckets
    )
    import jax.numpy as _jnp

    oh_dtype = _jnp.int8 if onehot_dtype is None else onehot_dtype
    onehot_bytes = C * total_slots * _jnp.dtype(oh_dtype).itemsize
    if onehot_bytes > max_onehot_bytes:
        raise ValueError(
            f"track-table one-hot would be {onehot_bytes / 1e9:.2f} GB "
            f"(C={C}, slots={total_slots}); use the wtt or grid engine for "
            "this camera count"
        )

    buckets = []
    offsets = []
    off = 0
    for b in g.buckets:
        ti = np.asarray(jax.device_get(b.track_idx))  # (Pb, Tb)
        tc = np.asarray(jax.device_get(b.track_cam))
        tm = np.asarray(jax.device_get(b.track_mask))
        Pb, Tb = ti.shape
        uv_slot = uv_flat[ti]  # (Pb, Tb, 2)
        uv_planes = np.ascontiguousarray(np.transpose(uv_slot, (2, 1, 0)))
        mask_planes = np.ascontiguousarray(tm.T)
        cam_planes = np.ascontiguousarray(tc.T).astype(np.int32)
        n = Tb * Pb
        onehot = np.zeros((C, n), np_dtype)
        flat_cam = cam_planes.reshape(n)
        flat_mask = mask_planes.reshape(n)
        real = np.nonzero(flat_mask > 0)[0]
        onehot[flat_cam[real], real] = 1.0
        oh_arr = jnp.asarray(onehot, oh_dtype)
        buckets.append(
            TTBucket(
                uv=jnp.asarray(uv_planes),
                mask=jnp.asarray(mask_planes),
                cam_ids=jnp.asarray(cam_planes),
                onehot=oh_arr,
            )
        )
        offsets.append(off)
        off += Pb

    return BATTProblem(
        cameras=g.cameras,
        points3d=g.points3d,
        buckets=tuple(buckets),
        avg_cam_width=g.avg_cam_width,
        point_rows=g.point_rows,
        n_real_points=g.n_real_points,
        bucket_offsets=tuple(offsets),
    )
