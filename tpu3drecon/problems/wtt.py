"""Windowed track-table BA problem: the gather-free layout at BAL scale.

The plain track table (problems/tt.py) pays an O(C * slots) one-hot — cheap
at moderate camera counts, impossible at BAL scale (C=1712 would need
~31 GB).  This layout exploits the camera LOCALITY of real capture:
bundle-adjustment tracks are short (mean 2-3) and, on sequential datasets
(BAL's Ladybug et al.), a track's cameras are consecutive ids.  Sorting
points by their minimum observing camera and chunking the point axis makes
each chunk's observations fall inside a narrow camera WINDOW:

  - points are ordered by min observing camera inside each track-length
    bucket (problems/grid.py ``order_points_by_cam``) and split into chunks
    of ``point_chunk`` columns;
  - chunk g stores a window-relative one-hot of shape (W, Tb*Pc) where
    ``W`` is the 128-aligned max window span over chunks — O(W * slots)
    total, independent of C;
  - the camera axis is padded to a multiple of 128 so windows are
    TILE-ALIGNED: the engine (solvers/ba_wtt.py) gathers each chunk's
    (W, d) parameter window and scatter-adds each chunk's (W, d) reductions
    as whole (128, d) tiles — G*W/128 indices total, never per-row.

On camera-local data W stays at 128-512 regardless of C, so the windowed
one-hot is ~W/C of the dense one (e.g. 0.4 GB instead of 31 GB for
Ladybug-1723 at f32).  On camera-DISLOCAL data (synthetic all-see-all) W
degenerates toward C_pad and the layout smoothly becomes the dense tt one.

No reference counterpart: the reference's jaxopt BA materializes dense
Jacobians (src/reconstruction/bundle_adjustment/bundle_adjustment.py:83-91)
and cannot run any of these scales.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu3drecon.problems.grid import grid_bucketed_from_flat
from tpu3drecon.problems.packing import BAProblem, CameraParams

CAM_TILE = 128


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class WTTBucket:
    """One track-length bucket, chunked along the point axis.

    ``G`` chunks of ``Pc`` points each; slot tables are chunk-major with the
    (Tb, Pc) slot axes last.  ``onehot[g, w, n]`` selects window-relative
    camera ``w`` for flat slot ``n = t * Pc + p`` of chunk ``g``;
    ``cam_base[g]`` (a multiple of 128) maps it back to the global camera
    axis.  Padding slots carry all-zero one-hot columns.

    ``window`` is PER BUCKET: short-track buckets are small but camera-wide
    (their few points span the whole trajectory after the camera-local
    sort), so a global window would degenerate to c_pad for everyone; the
    dominant long-track buckets keep their narrow local windows instead.

    Hub/global split (dislocal photo-tourism scenes): ``global_tiles`` > 0
    means the LAST ``128 * global_tiles`` one-hot rows address the shared
    global camera region (tiles ``global_tile0..``, where the packer put
    the high-co-visibility hub cameras) instead of the chunk-local window
    — every chunk sees its narrow local window PLUS the same global tiles.
    ``window`` is the TOTAL one-hot row count (local + global rows).
    """

    uv: jax.Array  # (G, 2, Tb, Pc)
    mask: jax.Array  # (G, Tb, Pc)
    onehot: jax.Array  # (G, W, Tb*Pc) {0,1}; None while deferred (see wcam)
    cam_base: jax.Array  # (G,) int32, multiples of 128
    # Compact one-hot: window-relative camera index per slot (-1 = padding).
    # ``wtt_from_flat(defer_onehot=True)`` ships this int16 form (1/W of the
    # dense bytes) and ``expand_onehots`` materializes ``onehot`` ON DEVICE —
    # the host->device stream drops from GBs to MBs at BAL scale.
    wcam: jax.Array = None  # (G, Tb*Pc) int16
    window: int = dataclasses.field(default=CAM_TILE, metadata=dict(static=True))
    # Shared global (hub) camera tiles appended to every chunk's window.
    global_tiles: int = dataclasses.field(default=0, metadata=dict(static=True))
    global_tile0: int = dataclasses.field(default=0, metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BAWTTProblem:
    """BA problem in windowed track-table layout.

    Points are permuted into bucket-major (and camera-local) order exactly
    like BAGridBucketedProblem (``point_rows`` maps back; use
    ``tpu3drecon.problems.grid.unpermute_points``).  ``window`` here is the
    MAX over the per-bucket windows (informational); the engine reads each
    bucket's own ``WTTBucket.window``.
    """

    cameras: CameraParams
    points3d: jax.Array  # (P_total, 3) permuted + padded
    buckets: Tuple[WTTBucket, ...]
    avg_cam_width: jax.Array  # ()
    point_rows: jax.Array = None
    # Camera relabeling applied at pack time for window locality
    # (problems/reorder.py): row ``new`` of ``cameras`` is original camera
    # ``cam_rows[new]``.  None = identity.  Engines un-permute their camera
    # output with this so callers always see original camera order.
    cam_rows: jax.Array = None
    n_real_points: int = dataclasses.field(default=0, metadata=dict(static=True))
    bucket_offsets: Tuple[int, ...] = dataclasses.field(
        default=(), metadata=dict(static=True)
    )
    window: int = dataclasses.field(default=CAM_TILE, metadata=dict(static=True))
    c_pad: int = dataclasses.field(default=CAM_TILE, metadata=dict(static=True))

    @property
    def n_cameras(self) -> int:
        return self.cameras.rmats.shape[0]


def _pad_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@functools.partial(jax.jit, static_argnames=("window", "dtype"))
def _expand_wcam(wcam: jax.Array, window: int, dtype) -> jax.Array:
    """(G, n) window-relative camera indices -> (G, W, n) one-hot.

    Padding slots carry -1, which matches no window row, so they expand to
    exact-zero columns — the same invariant the host packer guarantees.
    """
    w = jnp.arange(window, dtype=jnp.int32)[None, :, None]
    return (wcam[:, None, :].astype(jnp.int32) == w).astype(dtype)


def expand_onehots(problem: BAWTTProblem, onehot_dtype=None) -> BAWTTProblem:
    """Materialize deferred one-hots (wtt_from_flat(defer_onehot=True)).

    Runs on the current default device: call AFTER placing the compact
    problem (utils.placement.commit), so the (G, W, n) one-hot is built in
    device memory instead of crossing the host->device link — at BAL scale
    that replaces a ~2 GB transfer with a ~15 MB one.
    """
    dt = jnp.int8 if onehot_dtype is None else onehot_dtype
    buckets = []
    for b in problem.buckets:
        if b.onehot is not None:
            buckets.append(b)
            continue
        oh = _expand_wcam(b.wcam, b.window, jnp.dtype(dt))
        # wcam stays: it is the compact form (7.6 MB at BAL scale next to
        # the 0.98 GB one-hot) that problem caches and re-expansion read.
        buckets.append(dataclasses.replace(b, onehot=oh))
    return dataclasses.replace(problem, buckets=tuple(buckets))


def unpermute_cameras(cameras: CameraParams, cam_rows) -> CameraParams:
    """Map relabeled camera output back to original camera order.

    ``cam_rows[new] = old`` (see BAWTTProblem.cam_rows); identity when None.
    Jit-safe (pure scatter-set of a permutation).
    """
    if cam_rows is None:
        return cameras
    rows = jnp.asarray(cam_rows)

    def unperm(x):
        return jnp.zeros_like(x).at[rows].set(x)

    return CameraParams(
        rmats=unperm(cameras.rmats),
        tvecs=unperm(cameras.tvecs),
        fx_fy=unperm(cameras.fx_fy),
        cx_cy_skew=unperm(cameras.cx_cy_skew),
        dist=unperm(cameras.dist),
    )


# Default per-bucket window-class cap under ``split_windows=True``.  Each
# class becomes its own WTTBucket — another set of per-bucket ops to
# compile: the UNCAPPED hub split produced 23 classes and ~4x the BAL
# compile time of the unsplit packing, so classes are merged down to this
# many per bucket.
_SPLIT_MAX_CLASSES = 4


def _split_class_cap(split_windows) -> int:
    """Per-bucket window-class cap implied by ``split_windows``.

    ``True`` -> the default cap ``_SPLIT_MAX_CLASSES``; an ``int`` N > 0
    -> cap N (large N ~= uncapped); ``0``/``False`` -> no split (callers
    never reach the cap in that case).
    """
    if split_windows is True:
        return _SPLIT_MAX_CLASSES
    cap = int(split_windows)
    if cap <= 0:
        raise ValueError(
            f"split_windows int cap must be > 0 (got {split_windows}); "
            "use False/0 to disable splitting"
        )
    return cap


def _coalesce_window_classes(runs_by_class, max_classes, n_gt, c_pad):
    """Merge window classes into at most ``max_classes`` covering bins.

    A class ``(w, gr)`` — local width ``w`` plus global-tile range ``gr``
    (``None`` or an inclusive tile-index hull ``(lo, hi)`` within the
    global region, round-5 verdict item 3) — may ride any bin ``(W, GR)``
    with ``W >= w`` and ``GR`` a superset range of ``gr``: a wider window
    with re-clamped 128-aligned bases still covers every chunk's camera
    span, and surplus global tiles cover chunks with all-zero selection
    rows — both directions preserve values exactly (padded rows
    contribute exact zeros).  The bin set is chosen by EXHAUSTIVE
    enumeration over the candidate covering keys (widths x observed
    range hulls — class counts are tiny), minimizing total
    selection-MACs (chunk count x bin window rows).  Infeasible subsets
    (some class uncovered) are rejected via the cost check — the widest
    key is NOT force-included, since {widest-local, narrow-global}
    covers can beat {widest-local, widest-global} when global classes
    are light.  When the subset count exceeds ``_ENUM_BUDGET`` (possible
    for intermediate user int caps), a deterministic greedy-add seeded
    with the guaranteed cover-all key is used instead.  A greedy
    pair-MERGE was measured pathological here (its final forced merge
    put 163 groups on a 1792-row window at cap 2, counted on the BAL-scale
    packing); greedy ADD never un-covers.
    Deterministic: candidates and ties resolve through sorted keys
    (``None`` ranges sort first via the ``(-1, -1)`` sentinel).
    """
    import itertools
    import math

    def _r(gr):  # sortable form: None -> (-1, -1)
        return (-1, -1) if gr is None else gr

    def rows(key):
        w, gr = key
        return w + ((gr[1] - gr[0] + 1) * CAM_TILE if gr is not None else 0)

    def n_chunks(runs):
        return sum(len(ids) for _, ids in runs)

    keys = sorted(runs_by_class, key=lambda k: (k[0], _r(k[1])))
    weights = {k: n_chunks(runs_by_class[k]) for k in keys}
    widths = sorted({w for w, _ in keys})
    granges = [gr for _, gr in keys if gr is not None]
    los = sorted({gr[0] for gr in granges})
    his = sorted({gr[1] for gr in granges})
    hulls = [None] + sorted(
        {(lo, hi) for lo in los for hi in his if lo <= hi}
    )
    full = (min(los), max(his)) if granges else None
    top = (widths[-1], full)
    cands = sorted(
        {
            (w, gr)
            for w in widths
            for gr in hulls
            if any(
                w >= kw
                and (kgr is None
                     or (gr is not None and gr[0] <= kgr[0] and gr[1] >= kgr[1]))
                for kw, kgr in keys
            )
        },
        key=lambda k: (k[0], _r(k[1])),
    )

    def admissible(bin_key, cls_key):
        if bin_key[0] < cls_key[0]:
            return False
        gr_b, gr_c = bin_key[1], cls_key[1]
        if gr_c is None:
            return True
        return gr_b is not None and gr_b[0] <= gr_c[0] and gr_b[1] >= gr_c[1]

    def subset_cost(subset):
        cost = 0
        for k in keys:
            fits = [rows(b) for b in subset if admissible(b, k)]
            if not fits:
                return None
            cost += weights[k] * min(fits)
        return cost

    def skey(key):
        return (key[0], _r(key[1]))

    n_bins = min(max_classes, len(cands))
    _ENUM_BUDGET = 200_000
    if math.comb(len(cands), n_bins) <= _ENUM_BUDGET:
        best = None
        for subset in itertools.combinations(cands, n_bins):
            cost = subset_cost(subset)
            if cost is None:
                continue
            cand = (cost, tuple(skey(b) for b in subset), subset)
            if best is None or cand[:2] < best[:2]:
                best = cand
        bins = best[2]
    else:
        chosen = [top]  # the only single-key cover-all
        while len(chosen) < n_bins:
            best_add = min(
                ((subset_cost(chosen + [c]), skey(c), c)
                 for c in cands if c not in chosen),
                key=lambda t: t[:2],
            )
            chosen.append(best_add[2])
        bins = tuple(sorted(chosen, key=skey))

    merged: dict = {}
    for k in keys:
        bk = min(
            (b for b in bins if admissible(b, k)),
            key=lambda b: (rows(b), skey(b)),
        )
        clamp = max(c_pad - bk[0], 0)
        merged.setdefault(bk, []).extend(
            (min(b, clamp), ids) for b, ids in runs_by_class[k]
        )
    return merged


def _choose_cap(run_lengths, max_waste: float = 0.125, min_groups: int = 1) -> int:
    """Group-size cap (in micro-chunks): fewest groups within a padding cap.

    Groups are consecutive runs of micro-chunks sharing a cam_base; a run
    longer than the cap splits into several groups of the same base, and
    every group pads to ``cap`` micro-chunks (padded total
    sum(ceil(r/cap))*cap).  Minimize the GROUP COUNT subject to padding
    waste <= ``max_waste``: few, large batches are what batched matmuls
    want (hundreds of small batches ran far below the same work as a few
    large ones on the first accelerator), while cap=1 (zero
    padding, one group per micro-chunk) always stays admissible as the
    dislocal-data fallback.

    ``min_groups`` (the mesh size for the sharded engine) keeps at least
    that many groups when admissible, so devices don't idle.
    """
    if not run_lengths:
        return 1
    base_total = sum(run_lengths)
    candidates = []
    for cap in range(1, max(run_lengths) + 1):
        total = sum(((r + cap - 1) // cap) * cap for r in run_lengths)
        if total > base_total * (1.0 + max_waste):
            continue
        groups = sum((r + cap - 1) // cap for r in run_lengths)
        candidates.append((cap, groups, total))
    pool = [c for c in candidates if c[1] >= min_groups] or candidates
    best = min(pool, key=lambda c: (c[1], c[2], -c[0]))
    return best[0]


def _slots_estimate(pt_idx_real: np.ndarray, n_points: int,
                    bounds: Tuple[int, ...]) -> float:
    """Approximate total slot columns of the bucketed track table (per-point
    track length rounded up to its bucket bound, ~13% group padding)."""
    counts = np.bincount(pt_idx_real, minlength=n_points)
    counts = counts[counts > 0]
    tb = np.asarray(sorted(bounds), np.int64)
    idx = np.searchsorted(tb, counts)
    rounded = np.where(idx < len(tb), tb[np.minimum(idx, len(tb) - 1)], counts)
    return float(rounded.sum()) * 1.13


def wtt_from_flat(
    problem: BAProblem,
    bounds: Tuple[int, ...] = (2, 3, 4, 8),
    point_chunk: int = 512,
    max_onehot_bytes: int = 8 << 30,
    chunk_multiple: int = 1,
    onehot_dtype=None,
    reorder_cameras: str = "auto",
    defer_onehot: bool = False,
    split_windows: bool | int = False,
) -> BAWTTProblem:
    """Repack a flat BAProblem into the windowed track-table layout.

    ``point_chunk`` is the MICRO-chunk width used to detect camera
    locality; micro-chunks sharing the same 128-aligned window base are
    merged into GROUPS (the arrays' leading axis), so the engine sees few,
    large one-hot batches — B ~ c_pad/128 groups of ~slots/B columns on
    sequential data — instead of hundreds of small ones (see
    ``_choose_cap``).  On camera-dislocal data every
    micro-chunk keeps its own base and the layout degrades gracefully to
    per-chunk batches.

    The windows are derived from the data: the max 128-aligned camera span
    of any micro-chunk, per bucket.  Raises ``ValueError`` if the windowed
    one-hots would exceed ``max_onehot_bytes``.

    ``chunk_multiple`` pads every bucket's group count to a multiple (pass
    the mesh size for the sharded engine, which splits the group axis
    across devices: parallel/sharded_wtt.py).  Padding groups carry
    all-zero masks/one-hots and contribute exact zeros.

    ``split_windows`` refines the per-bucket window to MICRO-CHUNK
    granularity: chunks are classed by their own 128-aligned window (and,
    under a hub split, by whether they touch any global camera after a
    stable (has_global, min_local_cam) point re-sort), and each class
    becomes its own WTTBucket.  The engine's one-hot selection work is
    window_rows x slots, so the narrow majority classes cut the dominant
    MAC passes ~2x at BAL scale (measured MAC ratios 0.511x sequential /
    0.501x hub, counted on the BAL-scale packings) at the cost of more,
    smaller group batches, which the XLA einsum paths handle worse
    (batched-matmul throughput decays with many small batches) — hence
    off by default.  All-padding chunks are dropped outright.  Values are
    step-equivalent to the unsplit packing (same contributions, different
    f32 summation order).  ``True`` caps the classes per bucket at
    ``_SPLIT_MAX_CLASSES`` (each class is a separate bucket to compile)
    by merging classes into exact covering bins; pass an ``int`` to
    choose the cap yourself (a large value ~= uncapped).

    ``reorder_cameras`` controls the window-locality relabeling
    (problems/reorder.py — RCM on the co-visibility graph): ``"auto"``
    relabels when it shrinks the mean track span, ``"always"`` forces the
    RCM order, ``"never"`` keeps the input ids, ``"hub"`` forces the
    hub/global split planner.  On genuinely dislocal (core-periphery /
    photo-tourism) scenes no relabeling makes all windows narrow — the
    co-visibility graph's bandwidth is intrinsic — so ``"auto"`` estimates
    the post-RCM one-hot size and, when it would blow past
    ``max_onehot_bytes``, switches to the hub split: the highest-degree
    cameras are relabeled to the top of the camera axis and covered by
    shared GLOBAL window tiles on every chunk (WTTBucket.global_tiles)
    while the local majority keeps narrow windows.  The engines un-permute
    their camera output via ``cam_rows``, so callers see original camera
    order either way.
    """
    cam_rows = None
    n_local = problem.n_cameras
    if reorder_cameras not in ("auto", "always", "never", "hub"):
        raise ValueError(f"reorder_cameras={reorder_cameras!r}")
    oh_dtype_early = jnp.int8 if onehot_dtype is None else onehot_dtype
    if reorder_cameras != "never":
        from tpu3drecon.problems.reorder import (
            estimate_local_window,
            permute_cameras_flat,
            plan_camera_order,
            plan_hub_camera_order,
            rcm_camera_order,
        )

        ci = np.asarray(jax.device_get(problem.cam_idx))
        pi = np.asarray(jax.device_get(problem.pt_idx))
        mk = np.asarray(jax.device_get(problem.mask))
        perm = None
        if reorder_cameras == "always":
            real = mk > 0
            perm = rcm_camera_order(
                ci[real], pi[real], problem.n_cameras, problem.n_points
            )
        elif reorder_cameras == "hub":
            perm, n_local, _stats = plan_hub_camera_order(
                ci, pi, mk, problem.n_cameras, problem.n_points,
                point_chunk=point_chunk,
            )
        else:
            perm, _stats = plan_camera_order(
                ci, pi, mk, problem.n_cameras, problem.n_points
            )
            # Estimate the one-hot bytes the plain (RCM or input) order
            # yields; if they would not fit, try the hub/global split —
            # dislocal scenes fall through to it automatically.
            real = mk > 0
            cr, pr = ci[real].astype(np.int64), pi[real].astype(np.int64)
            if perm is not None:
                inv0 = np.empty(problem.n_cameras, np.int64)
                inv0[perm] = np.arange(problem.n_cameras)
            else:
                inv0 = np.arange(problem.n_cameras)
            w_plain = estimate_local_window(
                cr, pr, problem.n_points, inv0, problem.n_cameras,
                point_chunk=point_chunk,
            )
            slots_est = _slots_estimate(pr, problem.n_points, bounds)
            itemsize = jnp.dtype(oh_dtype_early).itemsize
            est_plain = w_plain * slots_est * itemsize
            if est_plain > 0.5 * max_onehot_bytes:
                hub_perm, hub_local, hub_stats = plan_hub_camera_order(
                    ci, pi, mk, problem.n_cameras, problem.n_points,
                    point_chunk=point_chunk,
                )
                if hub_stats["score"] * slots_est * itemsize < est_plain:
                    perm, n_local = hub_perm, hub_local
        if perm is not None:
            problem = permute_cameras_flat(problem, perm)
            cam_rows = perm

    g = grid_bucketed_from_flat(
        problem,
        bounds=bounds,
        point_block=point_chunk,
        order_points_by_cam=True,
    )
    guv = np.asarray(jax.device_get(g.uv))
    C, K = guv.shape[:2]
    uv_flat = guv.reshape(C * K, 2)
    np_dtype = uv_flat.dtype
    # int8 one-hot storage by default: {0,1} converts back exactly inside
    # the engine's contractions, and the dominant matvec one-hot stream is
    # 4x smaller than f32.
    oh_dtype = jnp.int8 if onehot_dtype is None else onehot_dtype
    c_pad = _pad_up(max(C, 1), CAM_TILE)
    Pc = point_chunk

    # Hub/global split geometry: cameras labeled >= glob_start live in the
    # shared global tiles (n_gt of them) appended to every chunk's window;
    # without a split glob_start = c_pad and n_gt = 0 (everything local).
    g_tile0 = (n_local // CAM_TILE) if n_local < C else (c_pad // CAM_TILE)
    glob_start = g_tile0 * CAM_TILE
    n_gt = c_pad // CAM_TILE - g_tile0

    # Pass 1 (host): per-bucket window + per-micro-chunk clamped bases +
    # grouping plan.  Short-track buckets are tiny but camera-wide after
    # the camera-local sort; windows are PER BUCKET so they don't poison
    # the dominant long-track buckets.
    #
    # ``split_windows`` refines this to MICRO-CHUNK granularity: each
    # 512-point chunk gets its own 128-aligned window CLASS (and, with a
    # hub split, its own needs-global flag after re-sorting points so
    # hub-observing points cluster), and chunks are grouped by
    # (base, class) into separate WTTBuckets per class.  The engine's
    # selection-dot work is window_rows x slots, so narrowing the
    # majority classes cuts the dominant MAC passes ~2x at BAL scale
    # (counted 0.511x sequential / 0.501x hub on the BAL-scale
    # packings) — the bucket-max window pays 256
    # rows for chunks that individually span < 128 cameras.
    plans = []  # (ti, tc, tm, window, groups, cap, n_gt_eff, porder, row_off)
    onehot_bytes = 0
    row_off = 0  # row offset of the current grid bucket inside g.points3d
    g_rows_all = np.asarray(jax.device_get(g.point_rows))
    for b in g.buckets:
        ti = np.asarray(jax.device_get(b.track_idx))  # (Pb, Tb)
        tc = np.asarray(jax.device_get(b.track_cam))
        tm = np.asarray(jax.device_get(b.track_mask))
        Pb, Tb = ti.shape
        n_chunks = Pb // Pc
        porder = None
        if split_windows and n_gt > 0:
            # Cluster hub-observing points so the majority of chunks can
            # skip the shared global tiles entirely, and — within the
            # hub-observing half — by their global-tile HULL (round-5
            # verdict item 3: most hub-touching points see ONE hub, so
            # hull-pure chunks carry one 128-row global tile instead of
            # the whole global region).  Stable: preserves the
            # camera-local order inside each hull group.
            real = tm > 0
            loc = np.where(real & (tc < glob_start), tc, np.iinfo(np.int64).max)
            min_local = loc.min(axis=1)
            gp = np.where(real & (tc >= glob_start), tc - glob_start, -1)
            has_gp = gp.max(axis=1) >= 0
            g_hi_p = np.maximum(gp.max(axis=1), 0) // CAM_TILE
            gp_lo = np.where(gp >= 0, gp, np.iinfo(np.int64).max)
            g_lo_p = np.minimum(gp_lo.min(axis=1) // CAM_TILE, n_gt - 1)
            porder = np.lexsort((min_local, g_hi_p, g_lo_p, has_gp))
            ti, tc, tm = ti[porder], tc[porder], tm[porder]

        if split_windows:
            # Per-chunk (base, window class, needs-global); None = padding
            # chunk (no real observation AND no real point row) — dropped
            # outright.  Chunks holding real-but-unobserved points (all
            # obs masked) are KEPT at the minimum window so those points
            # ride through the solve unchanged, matching the unsplit
            # packing and the other engines.
            rows_b = g_rows_all[row_off : row_off + Pb]
            if porder is not None:
                rows_b = rows_b[porder]
            keys = []
            for gi in range(n_chunks):
                sl = slice(gi * Pc, (gi + 1) * Pc)
                cams = tc[sl][tm[sl] > 0]
                if cams.size == 0:
                    if (rows_b[sl] < 0).all():
                        keys.append(None)
                    else:
                        keys.append((0, CAM_TILE, None))
                    continue
                gcams = cams[cams >= glob_start]
                if gcams.size:
                    # Inclusive global-tile hull this chunk touches —
                    # classes carry per-RANGE global tiles instead of the
                    # whole global region (round-5 verdict item 3).
                    grange = (
                        int(gcams.min() - glob_start) // CAM_TILE,
                        int(gcams.max() - glob_start) // CAM_TILE,
                    )
                else:
                    grange = None
                local = cams[cams < glob_start]
                if local.size:
                    base = (int(local.min()) // CAM_TILE) * CAM_TILE
                    wcls = min(
                        _pad_up(int(local.max()) - base + 1, CAM_TILE), c_pad
                    )
                    base = min(base, c_pad - wcls)
                else:
                    base, wcls = 0, 0
                keys.append((base, wcls, grange))

            # Runs of consecutive equal keys (dropped chunks are
            # transparent), collected per (class, has_global).
            runs_by_class: dict = {}
            cur_key, cur_ids = None, []
            for gi, k in enumerate(keys + [False]):
                if k is None:
                    continue
                if k == cur_key:
                    cur_ids.append(gi)
                    continue
                if cur_key is not None:
                    runs_by_class.setdefault(cur_key[1:], []).append(
                        (cur_key[0], cur_ids)
                    )
                cur_key, cur_ids = (k, [gi]) if k is not False else (None, [])

            max_cls = _split_class_cap(split_windows)
            if max_cls and len(runs_by_class) > max_cls:
                runs_by_class = _coalesce_window_classes(
                    runs_by_class, max_cls, n_gt, c_pad
                )

            for (wcls, grange) in sorted(
                runs_by_class,
                key=lambda k: (k[0], (-1, -1) if k[1] is None else k[1]),
            ):
                runs = runs_by_class[(wcls, grange)]
                cap = _choose_cap(
                    [len(ids) for _, ids in runs],
                    min_groups=max(chunk_multiple, 1),
                )
                groups = []
                for base, ids in runs:
                    for lo in range(0, len(ids), cap):
                        groups.append((base, ids[lo : lo + cap]))
                while len(groups) % max(chunk_multiple, 1):
                    groups.append((0, []))
                n_gt_eff = (grange[1] - grange[0] + 1) if grange else 0
                plans.append(
                    (ti, tc, tm, wcls, groups, cap, grange, porder, row_off)
                )
                onehot_bytes += (
                    (wcls + n_gt_eff * CAM_TILE)
                    * len(groups) * Tb * cap * Pc
                    * jnp.dtype(oh_dtype).itemsize
                )
            row_off += Pb
            continue

        window = CAM_TILE
        raw_bases = np.zeros(n_chunks, np.int64)
        has_obs = np.zeros(n_chunks, bool)
        for gi in range(n_chunks):
            sl = slice(gi * Pc, (gi + 1) * Pc)
            cams = tc[sl][tm[sl] > 0]
            cams = cams[cams < glob_start]  # globals ride the shared tiles
            if cams.size == 0:
                continue
            has_obs[gi] = True
            base = (int(cams.min()) // CAM_TILE) * CAM_TILE
            span = int(cams.max()) - base + 1
            raw_bases[gi] = base
            window = max(window, _pad_up(span, CAM_TILE))
        window = min(window, c_pad)

        # Clamp bases inside c_pad; give empty (padding) micro-chunks the
        # previous chunk's base so they merge into its group for free.
        bases = np.minimum(raw_bases, c_pad - window)
        prev = 0
        for gi in range(n_chunks):
            if has_obs[gi]:
                prev = int(bases[gi])
            else:
                bases[gi] = prev

        # Runs of equal base -> groups (runs longer than cap split).
        runs = []
        for gi in range(n_chunks):
            if runs and bases[gi] == runs[-1][0]:
                runs[-1][1] += 1
            else:
                runs.append([int(bases[gi]), 1])
        cap = _choose_cap(
            [r for _, r in runs], min_groups=max(chunk_multiple, 1)
        )
        groups = []  # (base, [micro-chunk indices])
        gi = 0
        for base, r in runs:
            for lo in range(0, r, cap):
                groups.append((base, list(range(gi + lo, gi + min(lo + cap, r)))))
            gi += r
        while len(groups) % max(chunk_multiple, 1):
            groups.append((0, []))

        plans.append((
            ti, tc, tm, window, groups, cap,
            (0, n_gt - 1) if n_gt else None, None, row_off,
        ))
        row_off += Pb
        onehot_bytes += (
            (window + n_gt * CAM_TILE)
            * len(groups) * Tb * cap * Pc * jnp.dtype(oh_dtype).itemsize
        )

    if onehot_bytes > max_onehot_bytes:
        raise ValueError(
            f"windowed one-hots would be {onehot_bytes / 1e9:.2f} GB "
            f"(windows={[p[3] for p in plans]}); data has too little camera "
            "locality at this scale — use the grid/pallas/sharded engines"
        )

    g_pts = np.asarray(jax.device_get(g.points3d))
    g_rows = np.asarray(jax.device_get(g.point_rows))

    buckets = []
    offsets = []
    pts_chunks = []
    rows_chunks = []
    off = 0
    for ti, tc, tm, window, groups, cap, grange, porder, g_off in plans:
        # grange: inclusive global-tile hull (lo, hi) within the global
        # region this class carries (None = no global rows).  Global
        # cameras index window rows relative to the hull's base tile, and
        # the bucket's global_tile0 points the scatter at it — the engine
        # is tile-index agnostic (_window_idx), so narrower per-class
        # global rows cost nothing downstream.
        g_lo = grange[0] if grange else 0
        n_gt_eff = (grange[1] - grange[0] + 1) if grange else 0
        g_base = glob_start + g_lo * CAM_TILE
        Pb, Tb = ti.shape
        B = len(groups)
        Pc_eff = cap * Pc
        n = Tb * Pc_eff
        uv_b = np.zeros((B, 2, Tb, Pc_eff), np_dtype)
        mask_b = np.zeros((B, Tb, Pc_eff), np_dtype)
        wcam_b = np.full((B, n), -1, np.int16)
        cam_base = np.zeros((B,), np.int32)
        sel = np.full((B, Pc_eff), -1, np.int64)  # g.points3d row per column
        for bi, (base, chunk_ids) in enumerate(groups):
            cam_base[bi] = base
            for j, gi in enumerate(chunk_ids):
                sl = slice(gi * Pc, (gi + 1) * Pc)
                ti_g = ti[sl].T  # (Tb, Pc)
                tc_g = tc[sl].T
                tm_g = tm[sl].T
                col0 = j * Pc
                uv_b[bi, :, :, col0 : col0 + Pc] = np.transpose(
                    uv_flat[ti_g], (2, 0, 1)
                )
                mask_b[bi, :, col0 : col0 + Pc] = tm_g
                tt_i, pp = np.nonzero(tm_g > 0)
                cols = tt_i * Pc_eff + col0 + pp
                tcv = tc_g[tm_g > 0]
                # Local cameras index their chunk window; globals index the
                # shared tail rows [window, window + n_gt_eff*128).
                wcam_b[bi, cols] = np.where(
                    tcv < glob_start, tcv - base,
                    window + (tcv - g_base),
                )
                rows_g = np.arange(gi * Pc, (gi + 1) * Pc)
                if porder is not None:
                    rows_g = porder[rows_g]
                sel[bi, col0 : col0 + Pc] = g_off + rows_g
        total_rows = window + n_gt_eff * CAM_TILE
        # wcam is retained even when the dense one-hot is materialized: it
        # is the compact form expand_onehots rebuilds from, and at 2
        # bytes/slot it is 1/window of the one-hot bytes.
        wcam = jnp.asarray(wcam_b)
        if defer_onehot:
            onehot = None
        else:
            onehot_b = np.zeros((B, total_rows, n), np_dtype)
            rows, cols = np.nonzero(wcam_b >= 0)
            onehot_b[rows, wcam_b[rows, cols], cols] = 1.0
            onehot = jnp.asarray(onehot_b, oh_dtype)
        buckets.append(
            WTTBucket(
                uv=jnp.asarray(uv_b),
                mask=jnp.asarray(mask_b),
                onehot=onehot,
                cam_base=jnp.asarray(cam_base),
                wcam=wcam,
                window=total_rows,
                global_tiles=n_gt_eff,
                global_tile0=g_tile0 + g_lo,
            )
        )
        sel = sel.reshape(-1)
        valid = sel >= 0
        pts_k = np.zeros((sel.size, 3), g_pts.dtype)
        pts_k[valid] = g_pts[sel[valid]]
        rows_k = np.full(sel.size, -1, np.int32)
        rows_k[valid] = g_rows[sel[valid]]
        pts_chunks.append(pts_k)
        rows_chunks.append(rows_k)
        offsets.append(off)
        off += sel.size

    windows = [
        p[3] + ((p[6][1] - p[6][0] + 1) * CAM_TILE if p[6] else 0)
        for p in plans
    ]
    return BAWTTProblem(
        cameras=g.cameras,
        points3d=jnp.asarray(np.concatenate(pts_chunks, axis=0))
        if pts_chunks
        else g.points3d,
        buckets=tuple(buckets),
        avg_cam_width=g.avg_cam_width,
        point_rows=jnp.asarray(np.concatenate(rows_chunks, axis=0))
        if rows_chunks
        else g.point_rows,
        cam_rows=jnp.asarray(cam_rows.astype(np.int32))
        if cam_rows is not None
        else None,
        n_real_points=g.n_real_points,
        bucket_offsets=tuple(offsets),
        window=max(windows) if windows else CAM_TILE,
        c_pad=c_pad,
    )
