"""Camera reordering for window locality (bandwidth reduction).

The windowed track-table layout (problems/wtt.py) relies on each point
chunk's observing cameras spanning a NARROW window of camera ids.  On
sequential captures the raw ids already have that property; on shuffled or
unstructured (photo-tourism) scenes they do not, and the windows degenerate
toward c_pad and the engine loses its advantage.

Camera ids are an arbitrary labeling, so we are free to relabel: reverse
Cuthill-McKee on the camera co-visibility graph (cameras adjacent iff they
observe a common point) minimizes the bandwidth of the camera-camera
coupling structure — which is exactly the quantity the per-chunk windows
pay for.  A shuffled sequential scene recovers its chain ordering exactly;
community-structured photo collections get near-minimal bandwidth.

Host-side, numpy/scipy (packing-time pass, like the rest of problems/).
No reference counterpart: the reference's dense-Jacobian BA has no layout
to optimize (src/reconstruction/bundle_adjustment/bundle_adjustment.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def camera_covisibility(
    cam_idx: np.ndarray,
    pt_idx: np.ndarray,
    n_cameras: int,
    n_points: int,
):
    """Sparse CSR camera-camera co-visibility matrix (counts, symmetric)."""
    import scipy.sparse as sp

    data = np.ones(len(cam_idx), np.float64)
    b = sp.coo_matrix(
        (data, (cam_idx.astype(np.int64), pt_idx.astype(np.int64))),
        shape=(n_cameras, n_points),
    ).tocsr()
    b.data[:] = 1.0  # collapse duplicate (cam, pt) pairs to incidence
    return (b @ b.T).tocsr()


def rcm_camera_order(
    cam_idx: np.ndarray,
    pt_idx: np.ndarray,
    n_cameras: int,
    n_points: int,
) -> np.ndarray:
    """RCM ordering of cameras: ``perm[new] = old`` (a permutation of
    range(n_cameras)).  Cameras sharing tracks end up with close ids."""
    import scipy.sparse.csgraph as csgraph

    adj = camera_covisibility(cam_idx, pt_idx, n_cameras, n_points)
    perm = csgraph.reverse_cuthill_mckee(adj, symmetric_mode=True)
    return np.asarray(perm, np.int64)


def track_span_cost(
    cam_idx: np.ndarray,
    pt_idx: np.ndarray,
    n_points: int,
    relabel: Optional[np.ndarray] = None,
) -> float:
    """Mean per-track camera-id span (the window-width proxy).

    ``relabel[old_cam] = new_cam`` evaluates a candidate ordering without
    repacking anything.  Lower = narrower wtt windows.
    """
    cams = cam_idx if relabel is None else relabel[cam_idx]
    hi = np.full(n_points, -1, np.int64)
    lo = np.full(n_points, np.iinfo(np.int64).max, np.int64)
    np.maximum.at(hi, pt_idx, cams)
    np.minimum.at(lo, pt_idx, cams)
    observed = hi >= 0
    if not observed.any():
        return 0.0
    return float(np.mean(hi[observed] - lo[observed] + 1))


def plan_camera_order(
    cam_idx: np.ndarray,
    pt_idx: np.ndarray,
    mask: np.ndarray,
    n_cameras: int,
    n_points: int,
    min_gain: float = 0.95,
) -> Tuple[Optional[np.ndarray], dict]:
    """Decide whether to relabel cameras; returns (perm or None, stats).

    ``perm[new] = old``; None means the existing order is already within
    ``min_gain`` of the RCM order's span cost (sequential captures land
    here — RCM recovers the chain, the proxy ties, no repack indirection).
    """
    real = np.asarray(mask) > 0
    ci = np.asarray(cam_idx)[real]
    pi = np.asarray(pt_idx)[real]
    base_cost = track_span_cost(ci, pi, n_points)
    try:
        perm = rcm_camera_order(ci, pi, n_cameras, n_points)
    except ImportError:  # scipy absent: keep original order
        return None, {"span_before": base_cost, "span_after": base_cost,
                      "reordered": False, "reason": "scipy unavailable"}
    inv = np.empty(n_cameras, np.int64)
    inv[perm] = np.arange(n_cameras)
    rcm_cost = track_span_cost(ci, pi, n_points, relabel=inv)
    stats = {"span_before": base_cost, "span_after": rcm_cost,
             "reordered": rcm_cost < base_cost * min_gain}
    if not stats["reordered"]:
        return None, stats
    return perm, stats


def estimate_local_window(
    cam_idx: np.ndarray,
    pt_idx: np.ndarray,
    n_points: int,
    relabel: np.ndarray,
    n_local: int,
    point_chunk: int = 512,
    tile: int = 128,
) -> int:
    """Estimate the wtt LOCAL window (128-aligned rows) a relabeling yields.

    Mirrors the packer's plan (problems/wtt.py pass 1) without packing:
    points sorted by min observing LOCAL camera, chunked ``point_chunk``
    wide, window = max 128-aligned local span of any chunk.  Cameras with
    new label >= ``n_local`` are globals (covered by shared global tiles)
    and do not stretch the windows.  Ignores track-length bucketing (one
    pooled chunking), so it is an upper-bound-flavored estimate used only
    to COMPARE candidate splits.
    """
    cams = relabel[cam_idx]
    local = cams < n_local
    hi = np.full(n_points, -1, np.int64)
    lo = np.full(n_points, np.iinfo(np.int64).max, np.int64)
    np.maximum.at(hi, pt_idx[local], cams[local])
    np.minimum.at(lo, pt_idx[local], cams[local])
    observed = hi >= 0
    if not observed.any():
        return tile
    lo_o, hi_o = lo[observed], hi[observed]
    order = np.argsort(lo_o, kind="stable")
    lo_o, hi_o = lo_o[order], hi_o[order]
    window = tile
    for s in range(0, len(lo_o), point_chunk):
        base = (int(lo_o[s]) // tile) * tile
        span = int(hi_o[s : s + point_chunk].max()) - base + 1
        window = max(window, ((span + tile - 1) // tile) * tile)
    return window


def plan_hub_camera_order(
    cam_idx: np.ndarray,
    pt_idx: np.ndarray,
    mask: np.ndarray,
    n_cameras: int,
    n_points: int,
    fracs: Tuple[float, ...] = (0.0, 1 / 64, 1 / 32, 1 / 16, 1 / 8),
    point_chunk: int = 512,
    tile: int = 128,
) -> Tuple[Optional[np.ndarray], int, dict]:
    """Hub/local camera split for dislocal (photo-tourism) scenes.

    Core-periphery co-visibility graphs have intrinsically high bandwidth —
    hub cameras (popular viewpoints) co-observe with everyone, so no single
    relabeling makes every wtt window narrow.  The fix is a SPLIT: move the
    highest-degree cameras to the top of the camera axis (the "global" set,
    covered by shared window tiles in problems/wtt.py) and RCM-order the
    remaining local subgraph.

    For each candidate global fraction, score = estimated local window +
    global tile rows; returns ``(perm, n_local, stats)`` minimizing it
    (``perm[new] = old``; globals occupy labels ``n_local..``).  frac 0.0
    (plain RCM, no globals) competes on equal terms, so camera-local scenes
    never pay for tiles they don't need.
    """
    import scipy.sparse.csgraph as csgraph

    real = np.asarray(mask) > 0
    ci = np.asarray(cam_idx)[real].astype(np.int64)
    pi = np.asarray(pt_idx)[real].astype(np.int64)
    adj = camera_covisibility(ci, pi, n_cameras, n_points)
    deg = np.diff(adj.indptr)
    order_by_deg = np.argsort(-deg, kind="stable")

    c_pad = ((n_cameras + tile - 1) // tile) * tile
    best = None
    candidates = []
    for frac in fracs:
        k = int(round(n_cameras * frac))
        glob = np.sort(order_by_deg[:k]) if k else np.zeros(0, np.int64)
        local_ids = np.setdiff1d(np.arange(n_cameras), glob, assume_unique=False)
        n_local = len(local_ids)
        if n_local == 0:
            continue
        sub = adj[np.ix_(local_ids, local_ids)].tocsr()
        sub_perm = csgraph.reverse_cuthill_mckee(sub, symmetric_mode=True)
        perm = np.concatenate([local_ids[np.asarray(sub_perm, np.int64)], glob])
        inv = np.empty(n_cameras, np.int64)
        inv[perm] = np.arange(n_cameras)
        w_local = estimate_local_window(
            ci, pi, n_points, inv, n_local, point_chunk, tile
        )
        # Global rows cover [floor(n_local/tile)*tile, c_pad).
        g_tile0 = n_local // tile
        w_global = c_pad - g_tile0 * tile if k else 0
        score = w_local + w_global
        candidates.append(
            {"frac": frac, "n_global": k, "w_local": w_local,
             "w_global": w_global, "score": score}
        )
        if best is None or score < best[0]:
            best = (score, perm, n_local, k)

    score, perm, n_local, k = best
    stats = {
        "candidates": candidates,
        "n_global": k,
        "n_local": n_local,
        "score": score,
    }
    return perm, n_local, stats


def permute_cameras_flat(problem, perm: np.ndarray):
    """Relabel cameras of a flat BAProblem by ``perm[new] = old``.

    Host-side numpy pass; returns a new BAProblem whose camera rows and
    cam_idx follow the new labeling.  Callers must map solver camera output
    back with ``perm`` (row new of the solution is camera perm[new]).
    """
    import jax
    import jax.numpy as jnp

    from tpu3drecon.problems.packing import BAProblem, CameraParams

    cams = jax.device_get(problem.cameras)
    inv = np.empty(len(perm), np.int64)
    inv[perm] = np.arange(len(perm))
    cam_idx = np.asarray(jax.device_get(problem.cam_idx))
    new_cameras = CameraParams(
        rmats=jnp.asarray(np.asarray(cams.rmats)[perm]),
        tvecs=jnp.asarray(np.asarray(cams.tvecs)[perm]),
        fx_fy=jnp.asarray(np.asarray(cams.fx_fy)[perm]),
        cx_cy_skew=jnp.asarray(np.asarray(cams.cx_cy_skew)[perm]),
        dist=jnp.asarray(np.asarray(cams.dist)[perm]),
    )
    return BAProblem(
        cameras=new_cameras,
        points3d=problem.points3d,
        cam_idx=jnp.asarray(inv[cam_idx].astype(np.int32)),
        pt_idx=problem.pt_idx,
        uv=problem.uv,
        mask=problem.mask,
        avg_cam_width=problem.avg_cam_width,
    )
