"""Windowed track-table bundle adjustment: the gather-free engine at scale.

Same LM/implicit-Schur algorithm and trust-region control as every other
engine (equality asserted in tests/test_ba_wtt.py), running on the windowed
track table of problems/wtt.py:

  - identical per-slot residual/Jacobian plane math as the dense tt engine
    (solvers/ba_tt._tt_blocks, vmapped over the chunk axis);
  - every camera-axis interaction contracts chunk-local (W, Tb*Pc) one-hot
    windows instead of the dense (C, slots) matrix: batched matmuls of
    O(W * slots) work and memory, independent of the camera count;
  - window gather/scatter on the camera axis moves whole 128-row TILES
    (G*W/128 indices per reduction — never per-row, never per-observation),
    so the engine keeps the track-table property of zero per-row transport
    in the hot loop.

This is the BAL-scale form of the track-table design: W stays at 128-512 on
camera-local (sequential capture) data regardless of C.

No reference counterpart (the reference's BA caps at 15 cams / 400 points:
src/reconstruction/bundle_adjustment/bundle_adjustment.py:83-91).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from tpu3drecon.ops.jacobians import apply_se3_retraction
from tpu3drecon.problems.grid import unpermute_points
from tpu3drecon.problems.packing import CameraParams
from tpu3drecon.problems.wtt import (
    BAWTTProblem,
    CAM_TILE,
    WTTBucket,
    unpermute_cameras,
)
from tpu3drecon.solvers.ba_tt import (
    _cam_table,
    _coupling_offdiag_batched,
    _psum,
    _sym3_inv_planes,
    _triu_pairs,
    _tt_blocks,
    _tt_state,
    _u_g_contribs_batched,
    _unpack_sym,
)
from tpu3drecon.solvers.bundle_adjust import BAConfig, BAState, n_cam_params
from tpu3drecon.solvers.pcg import cho_block_precond, guarded_block_cholesky, pcg
from tpu3drecon.solvers.trust_region import trust_region_solve


def _window_idx(bucket: WTTBucket) -> jax.Array:
    """(G, W/128) int32 camera-TILE indices of each chunk's window.

    With a hub/global split (bucket.global_tiles > 0) the last tiles are
    the SHARED global region — identical for every chunk — matching the
    one-hot row layout [local window rows | global rows] the packer emits
    (problems/wtt.py).  Gather/scatter code downstream is tile-index
    agnostic, so the hybrid layout costs nothing there."""
    wb = (bucket.window - CAM_TILE * bucket.global_tiles) // CAM_TILE
    idx = bucket.cam_base[:, None] // CAM_TILE + jnp.arange(
        wb, dtype=bucket.cam_base.dtype
    )[None, :]
    if bucket.global_tiles:
        gt = bucket.global_tile0 + jnp.arange(
            bucket.global_tiles, dtype=bucket.cam_base.dtype
        )
        idx = jnp.concatenate(
            [idx, jnp.broadcast_to(gt[None, :], (idx.shape[0], bucket.global_tiles))],
            axis=1,
        )
    return idx


def _window_rows(x: jax.Array, widx: jax.Array) -> jax.Array:
    """Gather camera windows: (c_pad, d) -> (G, W, d) via tile gather."""
    d = x.shape[-1]
    blocks = x.reshape(-1, CAM_TILE, d)
    g, wb = widx.shape
    return blocks[widx].reshape(g, wb * CAM_TILE, d)


def _scatter_rows(rows: jax.Array, widx: jax.Array, c_pad: int) -> jax.Array:
    """Scatter-add camera windows: (G, W, d) -> (c_pad, d) via tile scatter."""
    g, w, d = rows.shape
    wb = w // CAM_TILE
    out = jnp.zeros((c_pad // CAM_TILE, CAM_TILE, d), rows.dtype)
    out = out.at[widx].add(rows.reshape(g, wb, CAM_TILE, d))
    return out.reshape(c_pad, d)


def _ohf(oh: jax.Array, dtype) -> jax.Array:
    """One-hot operand for an einsum against ``dtype`` data.

    bf16/int8 {0,1} one-hots ride jnp's implicit promotion (the widening
    convert can fold into the dot's operand read).  float8/int4 refuse
    implicit promotion, so they get the identical explicit convert here;
    every encoding produces bit-equal f32 dot inputs.
    """
    if oh.dtype in (jnp.float8_e4m3fn, jnp.float8_e5m2, jnp.int4):
        return oh.astype(dtype)
    return oh


def _cam_planes_w(table_pad: jax.Array, bucket: WTTBucket) -> jax.Array:
    """Per-slot camera parameters (G, D, Tb, Pc) via windowed one-hot matmul."""
    g, _, tb, pc = bucket.uv.shape
    widx = _window_idx(bucket)
    tw = _window_rows(table_pad, widx)  # (G, W, D)
    planes = jnp.einsum("gwd,gwn->gdn", tw, _ohf(bucket.onehot, tw.dtype))
    return planes.reshape(g, table_pad.shape[1], tb, pc)


def _resident_problem_bytes(problem, np_cam: int) -> int:
    """Static estimate of what lives in device memory across the whole
    solve: the
    one-hots + uv/mask (problem residency) and the per-bucket normals the
    engine keeps between phases (jc/jp planes + point-side factors)."""
    total = 0
    for b in problem.buckets:
        g, _, tb, pc = b.uv.shape
        S = g * tb * pc
        if b.onehot is not None:
            total += b.onehot.size * b.onehot.dtype.itemsize
        wcam = getattr(b, "wcam", None)
        if wcam is not None:
            total += wcam.size * wcam.dtype.itemsize
        total += b.uv.size * b.uv.dtype.itemsize
        total += b.mask.size * b.mask.dtype.itemsize
        itemsize = jnp.dtype(b.uv.dtype).itemsize
        total += (2 * np_cam + 6) * S * itemsize  # jc + jp normals
        total += 12 * g * pc * itemsize  # v_inv/g_pt/damp point planes
    return total


# Share of the device's memory limit one contribution chunk may take, and
# the reserve kept free for CG state and XLA's own buffers.  Carried over
# from the first accelerator (where 0.31 of 15.5 GB measured best at BAL
# scale); not yet tuned on the H100.
_PLANE_SHARE = 0.3
_RESERVE_SHARE = 0.1
_MIN_PLANE_BYTES = 300_000_000
# Host (CPU backend) budget, split across virtual devices: they share one
# host's RAM, and per-device transients multiply with the device count.
_HOST_PLANE_BYTES = 2_000_000_000


def _contrib_plane_budget(problem=None, np_cam: int = 8) -> int:
    """Transient-byte budget for one linearization contribution chunk.

    Chunks are independent slices of the group axis, so the budget changes
    only peak memory and the number of dots, never the values.  On an
    accelerator it is a share of ``memory_stats()["bytes_limit"]``
    (utils/device.py; an unknown limit is an error), clamped to what fits
    next to the problem's resident bytes (one-hots + uv/mask + retained
    jc/jp normals) and a reserve, so problems too big for the share shrink
    their chunks instead of failing to allocate.  Override with
    TPU3DRECON_PLANE_BYTES."""
    import os

    from tpu3drecon.utils.device import device_info, memory_bytes

    env = os.environ.get("TPU3DRECON_PLANE_BYTES")
    if env is not None:
        return int(env)
    info = device_info()
    if info.platform == "cpu":
        return _HOST_PLANE_BYTES // max(1, info.count)
    limit = memory_bytes()
    budget = int(limit * _PLANE_SHARE)
    if problem is not None:
        free = (
            limit
            - _resident_problem_bytes(problem, np_cam)
            - int(limit * _RESERVE_SHARE)
        )
        budget = min(budget, max(_MIN_PLANE_BYTES, free))
    return budget


def _contrib_g_chunk(bucket: WTTBucket, np_cam: int, use_sj: bool,
                     want_od: bool, problem=None) -> int:
    """Group-chunk size keeping the per-chunk transient under budget."""
    g, _, tb, pc = bucket.uv.shape
    n_triu = np_cam * (np_cam + 1) // 2
    # f32 plane-equivalents alive per slot in one chunk: u planes + their
    # two gathered operands + gradient planes...
    k_eff = 3 * n_triu + np_cam
    if use_sj:
        # ... + coupling planes + W + WV ...
        k_eff += n_triu + 6 * np_cam
    if want_od:
        # ... + the np x np pair grid + the bf16 pair one-hot.
        k_eff += np_cam * np_cam + bucket.window // 2
    # Itemsize follows the problem dtype: under x64 (the CPU test mesh) the
    # transient planes are f64, twice the f32 estimate (ADVICE r3).
    itemsize = jnp.dtype(bucket.uv.dtype).itemsize
    per_g = tb * pc * itemsize * max(k_eff, 1)
    budget = _contrib_plane_budget(problem, np_cam)
    return max(1, min(g, budget // max(per_g, 1)))


def _reduce_to_cams_w(planes: jax.Array, bucket: WTTBucket, c_pad: int) -> jax.Array:
    """Sum stacked slot planes (K, G, Tb, Pc) into camera rows (c_pad, K):
    one one-hot dot per bucket (the K-operand comes pre-batched from the
    einsum contribution helpers, so there is no per-plane program blowup
    and no slab loop; the ~165-plane transient is ~2.4 GB at BAL scale)."""
    widx = _window_idx(bucket)
    k, g, tb, pc = planes.shape
    rows = jnp.einsum(
        "kgn,gwn->gwk",
        planes.reshape(k, g, tb * pc),
        _ohf(bucket.onehot, planes.dtype),
    )
    return _scatter_rows(rows, widx, c_pad)


class WTTBucketNormal(NamedTuple):
    jc: jax.Array  # (2*np, G, Tb, Pc)
    jp: jax.Array  # (6, G, Tb, Pc)
    v_inv: jax.Array  # (6, G, Pc) sym planes
    g_pt: jax.Array  # (3, G, Pc)
    damp_pt: jax.Array  # (3, G, Pc)


class WTTNormal(NamedTuple):
    u: jax.Array  # (c_pad, np, np) damped
    u_chol: jax.Array  # (c_pad, np, np)
    g_cam: jax.Array  # (c_pad, np)
    damp_cam: jax.Array  # (c_pad, np)
    buckets: Tuple[WTTBucketNormal, ...]
    tridiag: object = None  # TridiagFactor when config.precond == "tridiag"


def _wt_times_bucket_w(bn: WTTBucketNormal, x_pad: jax.Array, bucket: WTTBucket):
    """(W^T x) point planes (3, G, Pc) for one bucket."""
    np_cam = bn.jc.shape[0] // 2
    _, g, tb, pc = bn.jp.shape
    widx = _window_idx(bucket)
    xw = _window_rows(x_pad, widx)  # (G, W, np)
    xg = jnp.einsum(
        "gwi,gwn->ign", xw, _ohf(bucket.onehot, xw.dtype)
    ).reshape(np_cam, g, tb, pc)
    s0 = sum(bn.jc[i] * xg[i] for i in range(np_cam))
    s1 = sum(bn.jc[np_cam + i] * xg[i] for i in range(np_cam))
    return jnp.stack(
        [
            jnp.sum(bn.jp[0] * s0 + bn.jp[3] * s1, axis=1),
            jnp.sum(bn.jp[1] * s0 + bn.jp[4] * s1, axis=1),
            jnp.sum(bn.jp[2] * s0 + bn.jp[5] * s1, axis=1),
        ]
    )


def _w_times_bucket_w(bn: WTTBucketNormal, y_pt: jax.Array, bucket: WTTBucket, c_pad: int):
    """(W y) camera rows (c_pad, np) for one bucket; y_pt is (3, G, Pc)."""
    np_cam = bn.jc.shape[0] // 2
    yb = y_pt[:, :, None, :]  # (3, G, 1, Pc) broadcast over Tb
    s0 = bn.jp[0] * yb[0] + bn.jp[1] * yb[1] + bn.jp[2] * yb[2]
    s1 = bn.jp[3] * yb[0] + bn.jp[4] * yb[1] + bn.jp[5] * yb[2]
    jc2 = bn.jc.reshape((2, np_cam) + bn.jc.shape[1:])
    # Explicit mul+add, not einsum: a 2-wide dot_general wastes a matmul.
    z = jc2[0] * s0[None] + jc2[1] * s1[None]
    return _reduce_to_cams_w(z, bucket, c_pad)


def _schur_matvec(nb: WTTNormal, x_pad, problem: BAWTTProblem, axis_name=None):
    coup = jnp.zeros_like(x_pad)
    for bn, bucket in zip(nb.buckets, problem.buckets):
        wtx = _wt_times_bucket_w(bn, x_pad, bucket)
        vw = _sym3_matvec_g(bn.v_inv, wtx)
        coup = coup + _w_times_bucket_w(bn, vw, bucket, problem.c_pad)
    return jnp.einsum("cij,cj->ci", nb.u, x_pad) - _psum(coup, axis_name)


def _sym3_matvec_g(m6: jax.Array, x: jax.Array) -> jax.Array:
    """(3, G, Pc) = sym3(m6) @ x, both component-major."""
    return jnp.stack(
        [
            m6[0] * x[0] + m6[1] * x[1] + m6[2] * x[2],
            m6[1] * x[0] + m6[3] * x[1] + m6[4] * x[2],
            m6[2] * x[0] + m6[4] * x[1] + m6[5] * x[2],
        ]
    )


def _linearize(params, lam, problem: BAWTTProblem, config: BAConfig,
               axis_name=None) -> WTTNormal:
    rmats, tvecs, fx_fy, dist, ccs, pts_list = params
    dtype = pts_list[0].dtype
    c_pad = problem.c_pad
    table = _cam_table(rmats, tvecs, fx_fy, ccs, dist)
    table_pad = jnp.zeros((c_pad, table.shape[1]), dtype).at[: table.shape[0]].set(table)
    inv_w = (jnp.asarray(1.0, dtype) / problem.avg_cam_width).astype(dtype)

    np_cam = n_cam_params(config)
    triu = _triu_pairs(np_cam)
    n_triu = len(triu)
    use_sj = config.precond in ("schur_jacobi", "tridiag", "ssor")
    if config.precond in ("tridiag", "ssor") and any(
        b.global_tiles for b in problem.buckets
    ):
        # The S_{c,c+1} pair one-hot derives band entries from window-row
        # adjacency == camera-id adjacency, which breaks at the local/global
        # boundary of a hub split (hub cameras' couplings are scattered all
        # over S, not on the band).
        raise ValueError(
            "band preconditioners (ssor/tridiag) are not supported with "
            "hub/global camera tiles; use precond='schur_jacobi'"
        )
    u_cols = jnp.zeros((c_pad, n_triu), dtype)
    g_cols = jnp.zeros((c_pad, np_cam), dtype)
    coup_cols = jnp.zeros((c_pad, n_triu), dtype)
    e_cols = jnp.zeros((c_pad, np_cam * np_cam), dtype)
    bucket_normals = []
    want_od = config.precond in ("tridiag", "ssor")
    for bucket, pts in zip(problem.buckets, pts_list):
        g_b, _, tb_b, pc_b = bucket.uv.shape
        n_b = tb_b * pc_b
        cp = _cam_planes_w(table_pad, bucket)  # (G, D, Tb, Pc)
        blocks = jax.vmap(
            lambda c, p, u, m: _tt_blocks(c, p, u, m, inv_w, config),
            in_axes=(0, 1, 0, 0),
            out_axes=1,
        )(cp, pts, bucket.uv, bucket.mask)
        jc, jp, r = blocks.jc, blocks.jp, blocks.r  # (k, G, Tb, Pc)

        # Point-side normal: dense over Tb (axis=1 of each (G, Tb, Pc)).
        v6 = jnp.stack(
            [
                jnp.sum(jp[i] * jp[j] + jp[3 + i] * jp[3 + j], axis=1)
                for (i, j) in [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
            ]
        )  # (6, G, Pc)
        g_pt = jnp.stack(
            [jnp.sum(jp[i] * r[0] + jp[3 + i] * r[1], axis=1) for i in range(3)]
        )
        dv = jnp.clip(v6[jnp.asarray([0, 3, 5])], 1e-8, None)
        damp_pt = lam * dv
        v6_d = v6.at[jnp.asarray([0, 3, 5])].add(damp_pt)
        v_inv = _sym3_inv_planes(v6_d)

        # Batched (einsum) plane production — see ba_tt._u_g_contribs_batched
        # — chunked along the group axis so the transient plane tensors stay
        # bounded (~_contrib_plane_budget bytes): the unchunked batched form
        # needs ~19 GB of transients at BAL scale, the per-plane unrolled
        # form compiles for minutes.  Chunks are independent slices of G,
        # so values are bit-identical to the unchunked computation.
        gc = _contrib_g_chunk(bucket, np_cam, use_sj, want_od, problem)
        row_parts = []
        erow_parts = []
        for g0 in range(0, g_b, gc):
            g1 = min(g0 + gc, g_b)
            jc_s, jp_s, r_s = jc[:, g0:g1], jp[:, g0:g1], r[:, g0:g1]
            oh_s = _ohf(bucket.onehot[g0:g1], jc_s.dtype)
            contribs = _u_g_contribs_batched(jc_s, r_s, np_cam, triu)
            if use_sj:
                # v_inv is (6, G, Pc): broadcast over the Tb slot axis.
                coup, od = _coupling_offdiag_batched(
                    jc_s, jp_s, v_inv[:, g0:g1, None, :], np_cam, triu,
                    want_od,
                )
                contribs = jnp.concatenate([contribs, coup], axis=0)
            k = contribs.shape[0]
            row_parts.append(jnp.einsum(
                "kgn,gwn->gwk", contribs.reshape(k, g1 - g0, n_b), oh_s
            ))
            if want_od:
                # S_{c,c+1} blocks from adjacent-slot pairs (exactly as the
                # tt engine, ba_tt._linearize): window-relative here, so the
                # pair one-hot rolls along the WINDOW axis and the reduction
                # tile-scatters like every other camera reduction.  Track
                # camera lists are strictly increasing, so the wrap row
                # (w = W-1 paired with w = 0) is identically zero.
                pair_oh = (
                    oh_s[:, :, : n_b - pc_b]
                    * jnp.roll(oh_s, -1, axis=1)[:, :, pc_b:]
                )
                od_flat = od.reshape(
                    np_cam * np_cam, g1 - g0, (tb_b - 1) * pc_b
                )
                erow_parts.append(jnp.einsum("kgn,gwn->gwk", od_flat, pair_oh))
        widx = _window_idx(bucket)
        reduced = _scatter_rows(
            jnp.concatenate(row_parts, axis=0), widx, c_pad
        )
        u_cols = u_cols + reduced[:, :n_triu]
        g_cols = g_cols + reduced[:, n_triu : n_triu + np_cam]
        if use_sj:
            coup_cols = coup_cols + reduced[:, n_triu + np_cam : 2 * n_triu + np_cam]
        if want_od:
            e_cols = e_cols + _scatter_rows(
                jnp.concatenate(erow_parts, axis=0), widx, c_pad
            )
        if config.matvec_bf16:
            # Matvec-side planes in bf16: the linearization reductions above
            # consumed the f32 jc/jp; everything downstream (CG matvecs,
            # rhs, back-substitution) reads these at half the bytes,
            # with products promoting back to f32 (BAConfig.matvec_bf16).
            jc, jp = jc.astype(jnp.bfloat16), jp.astype(jnp.bfloat16)
        bucket_normals.append(
            WTTBucketNormal(jc=jc, jp=jp, v_inv=v_inv, g_pt=g_pt, damp_pt=damp_pt)
        )

    u_cols = _psum(u_cols, axis_name)
    g_cols = _psum(g_cols, axis_name)
    if use_sj:
        coup_cols = _psum(coup_cols, axis_name)
    u0 = _unpack_sym(u_cols, np_cam)
    eye = jnp.eye(np_cam, dtype=dtype)
    du = jnp.clip(jnp.diagonal(u0, axis1=-2, axis2=-1), 1e-8, None)
    damp_cam = lam * du
    u_d = u0 + damp_cam[..., None] * eye
    if use_sj:
        precond_mat = u_d - _unpack_sym(coup_cols, np_cam)
        u_chol = guarded_block_cholesky(precond_mat, u_d)
    else:
        precond_mat = u_d
        # Padding cameras have u0 = 0 and damp = lam*1e-8: SPD, inert.
        u_chol = jax.vmap(jnp.linalg.cholesky)(precond_mat)

    tridiag = None
    if config.precond in ("tridiag", "ssor"):
        from tpu3drecon.solvers.tridiag import (
            auto_segments,
            ssor_factor,
            tridiag_factor,
        )

        e_cols = _psum(e_cols, axis_name)
        e_blocks = -e_cols.reshape(c_pad, np_cam, np_cam)
        make = ssor_factor if config.precond == "ssor" else tridiag_factor
        tridiag = make(
            precond_mat, e_blocks, segments=auto_segments(c_pad)
        )

    return WTTNormal(
        u=u_d, u_chol=u_chol, g_cam=g_cols, damp_cam=damp_cam,
        buckets=tuple(bucket_normals), tridiag=tridiag,
    )


def _pcg(nb: WTTNormal, b: jax.Array, problem: BAWTTProblem, maxiter, rtol,
         axis_name=None):
    if nb.tridiag is not None:
        from tpu3drecon.solvers.tridiag import (
            SSORFactor,
            auto_segments,
            ssor_solve,
            tridiag_solve,
        )

        seg = auto_segments(nb.u_chol.shape[0])
        solve = (
            ssor_solve if isinstance(nb.tridiag, SSORFactor) else tridiag_solve
        )
        precond = lambda r: solve(nb.tridiag, r, segments=seg)  # noqa: E731
    else:
        precond = cho_block_precond(nb.u_chol)
    out = pcg(
        lambda p: _schur_matvec(nb, p, problem, axis_name),
        precond,
        b, maxiter, rtol,
    )
    return out.x, out.iters


def _cost(params, problem: BAWTTProblem, config: BAConfig, axis_name=None):
    from tpu3drecon.geometry.losses import robust_weight

    rmats, tvecs, fx_fy, dist, ccs, pts_list = params
    dtype = pts_list[0].dtype
    table = _cam_table(rmats, tvecs, fx_fy, ccs, dist)
    table_pad = jnp.zeros((problem.c_pad, table.shape[1]), dtype).at[
        : table.shape[0]
    ].set(table)
    inv_w = (jnp.asarray(1.0, dtype) / problem.avg_cam_width).astype(dtype)
    total = jnp.zeros((), dtype)
    for bucket, pts in zip(problem.buckets, pts_list):
        cp = _cam_planes_w(table_pad, bucket)  # (G, D, Tb, Pc)
        pb = pts[:, :, None, :]  # (3, G, 1, Pc)
        cpm = jnp.moveaxis(cp, 1, 0)  # (D, G, Tb, Pc)
        x = cpm[0] * pb[0] + cpm[1] * pb[1] + cpm[2] * pb[2] + cpm[9]
        y = cpm[3] * pb[0] + cpm[4] * pb[1] + cpm[5] * pb[2] + cpm[10]
        z = cpm[6] * pb[0] + cpm[7] * pb[1] + cpm[8] * pb[2] + cpm[11]
        iz = 1.0 / jnp.where(jnp.abs(z) < 1e-12, jnp.asarray(1.0, dtype), z)
        mx = x * iz
        my = y * iz
        r2 = mx * mx + my * my
        s_rad = 1.0 + cpm[17] * r2 + cpm[18] * r2 * r2
        u = cpm[12] * s_rad * mx + cpm[16] * s_rad * my + cpm[14]
        v = cpm[13] * s_rad * my + cpm[15]
        uv = jnp.moveaxis(bucket.uv, 1, 0)  # (2, G, Tb, Pc)
        r0 = u - uv[0]
        r1 = v - uv[1]
        s = r0 * r0 + r1 * r1
        w = robust_weight(config.loss, jax.lax.stop_gradient(s))
        total = total + 0.5 * jnp.sum(s * w * (bucket.mask * inv_w) ** 2)
    return _psum(total, axis_name)


def ba_solve_wtt(
    problem: BAWTTProblem, config: BAConfig = BAConfig()
) -> Tuple[CameraParams, jax.Array, BAState]:
    """Windowed track-table BA solve; same outputs and trust-region
    trajectory as ba_solve_tt / ba_solve_grid (tests/test_ba_wtt.py)."""
    if any(b.onehot is None for b in problem.buckets):
        raise ValueError(
            "problem has deferred one-hots (wtt_from_flat(defer_onehot=True));"
            " materialize them on the target device first (problems.wtt."
            "expand_onehots(commit(problem)))"
        )
    with jax.default_matmul_precision("highest"):
        pts_list = []
        for bucket, off in zip(problem.buckets, problem.bucket_offsets):
            g, _, tb, pc = bucket.uv.shape
            block = problem.points3d[off : off + g * pc]  # (G*Pc, 3)
            pts_list.append(
                jnp.moveaxis(block.reshape(g, pc, 3), 2, 0)  # (3, G, Pc)
            )
        cams, pts_out, final = _ba_solve_wtt_core(
            problem, tuple(pts_list), config
        )
        points3d = jnp.concatenate(
            [jnp.moveaxis(p, 0, 2).reshape(-1, 3) for p in pts_out], axis=0
        )
        pts = unpermute_points(points3d, problem)
        cams = unpermute_cameras(cams, problem.cam_rows)
        state = _tt_state(cams, pts, final)
        return cams, pts, state


def _ba_solve_wtt_core(problem: BAWTTProblem, pts_list, config: BAConfig,
                       axis_name=None):
    cams = problem.cameras
    dtype = pts_list[0].dtype
    n_cams = cams.rmats.shape[0]
    params0 = (
        cams.rmats, cams.tvecs, cams.fx_fy, cams.dist, cams.cx_cy_skew,
        pts_list,
    )

    def pmax(x):
        return jax.lax.pmax(x, axis_name) if axis_name else x

    def propose(params, lam):
        nb = _linearize(params, lam, problem, config, axis_name)
        gp_max = jnp.asarray(0.0, dtype)
        for bn in nb.buckets:
            gp_max = jnp.maximum(gp_max, jnp.max(jnp.abs(bn.g_pt)))
        grad_norm = jnp.maximum(
            jnp.max(jnp.abs(nb.g_cam)),
            pmax(gp_max) if config.optimize_points else 0.0,
        )

        b = jnp.zeros_like(nb.g_cam)
        for bn, bucket in zip(nb.buckets, problem.buckets):
            vw = _sym3_matvec_g(bn.v_inv, bn.g_pt)
            b = b + _w_times_bucket_w(bn, vw, bucket, problem.c_pad)
        b = _psum(b, axis_name) - nb.g_cam
        dc, cg_iters = _pcg(
            nb, b, problem, config.cg_maxiter, config.cg_rtol, axis_name,
        )

        dps = []
        pred_pt = jnp.zeros((), dtype)
        for bn, bucket in zip(nb.buckets, problem.buckets):
            wtx = _wt_times_bucket_w(bn, dc, bucket)
            dp = _sym3_matvec_g(bn.v_inv, -bn.g_pt - wtx)  # (3, G, Pc)
            if not config.optimize_points:
                dp = dp * 0.0
            pred_pt = pred_pt + 0.5 * (
                jnp.sum(dp * (bn.damp_pt * dp)) - jnp.sum(dp * bn.g_pt)
            )
            dps.append(dp)
        pred = (
            0.5 * (jnp.sum(dc * (nb.damp_cam * dc)) - jnp.sum(dc * nb.g_cam))
            + _psum(pred_pt, axis_name)
        )
        return (dc, tuple(dps)), grad_norm, pred, cg_iters

    def apply_step(params, delta):
        rmats, tvecs, fx_fy, dist, ccs, pts = params
        dc_pad, dps = delta
        dc = dc_pad[:n_cams]
        new_r, new_t, new_f = apply_se3_retraction(rmats, tvecs, fx_fy, dc[:, :8])
        off = 8
        new_d = dist
        if config.optimize_dist:
            new_d = dist + dc[:, off : off + 2]
            off += 2
        new_c = ccs
        if config.optimize_pp:
            new_c = ccs.at[:, :2].add(dc[:, off : off + 2])
        new_pts = tuple(p + dp for p, dp in zip(pts, dps))
        return (new_r, new_t, new_f, new_d, new_c, new_pts)

    cost = functools.partial(
        _cost, problem=problem, config=config, axis_name=axis_name
    )
    final = trust_region_solve(propose, apply_step, cost, params0, config, dtype)
    rmats, tvecs, fx_fy, dist, ccs, pts_out = final.params
    cameras_out = CameraParams(
        rmats=rmats, tvecs=tvecs, fx_fy=fx_fy, cx_cy_skew=ccs, dist=dist,
    )
    return cameras_out, pts_out, final


_WTT_SOLVER_CACHE: dict = {}
_WTT_JIT_CACHE: dict = {}


def make_wtt_ba_solver(config: BAConfig = BAConfig()):
    """Jitted wtt solver (cached).  Loop bounds/tolerances ride in as
    dynamic operands, so configs that differ only in those share one
    compiled executable."""
    if config not in _WTT_SOLVER_CACHE:
        from tpu3drecon.solvers.bundle_adjust import (
            dynamic_operands,
            merge_dynamic_config,
            static_config,
        )

        static = static_config(config)
        jfn = _WTT_JIT_CACHE.get(static)
        if jfn is None:
            jfn = jax.jit(
                lambda p, d, s=static: ba_solve_wtt(p, merge_dynamic_config(s, d))
            )
            _WTT_JIT_CACHE[static] = jfn
        _WTT_SOLVER_CACHE[config] = lambda p, _j=jfn, _c=config: _j(
            p, dynamic_operands(_c)
        )
    return _WTT_SOLVER_CACHE[config]
