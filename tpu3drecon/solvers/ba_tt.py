"""Track-table bundle adjustment: the gather-free engine.

Same LM/implicit-Schur algorithm and trust-region control as the
flat/grid engines (equality asserted in tests/test_ba_tt.py), but the
entire solve runs on the bucketed track table of problems/tt.py:

  - camera parameters per slot, U/g_cam accumulation, the Schur-coupling
    halves (W x and the camera reduce of W^T-products) are all contractions
    against the precomputed {0,1} one-hot matrix — dense matmuls, ZERO
    per-row gathers anywhere in the solve;
  - point-side quantities (V, g_pt, v_inv, back-substitution) are dense
    reductions over the T axis — the table is point-major, so the point
    broadcast in every coupling matvec is free;
  - everything is scalar *planes* with the big slot axis last (no trailing
    2/3/8 dims, so no tile padding).

The price is the O(C * slots) one-hot, which caps the layout at moderate
camera counts (see problems/tt.py).

Reference contrast: the reference's BA materializes a dense Jacobian through
jaxopt (src/reconstruction/bundle_adjustment/bundle_adjustment.py:83-91) and
is capped at 15 cams / 400 pts; this engine is a layout specialization of
this project — there is nothing comparable to copy.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from tpu3drecon.geometry.losses import robust_weight
from tpu3drecon.ops.jacobians import apply_se3_retraction
from tpu3drecon.problems.grid import unpermute_points
from tpu3drecon.problems.packing import CameraParams
from tpu3drecon.problems.tt import BATTProblem, TTBucket
from tpu3drecon.solvers.bundle_adjust import BAConfig, BAState, n_cam_params
from tpu3drecon.solvers.pcg import cho_block_precond, guarded_block_cholesky, pcg
from tpu3drecon.solvers.trust_region import trust_region_solve

# Column layout of the packed per-camera parameter table fed through the
# one-hot matmul: rmat row-major (9) | tvec (3) | fx fy | cx cy skew | k1 k2.
_CAM_TABLE_DIM = 19


def _cam_table(rmats, tvecs, fx_fy, cx_cy_skew, dist) -> jax.Array:
    C = rmats.shape[0]
    return jnp.concatenate(
        [rmats.reshape(C, 9), tvecs, fx_fy, cx_cy_skew, dist], axis=1
    )


def _flat_onehot(bucket: TTBucket) -> jax.Array:
    """One-hot as (C, Tb*Pb), from either stored form.

    Single-chip problems carry it pre-flattened (a trace-time no-op here) —
    the (C, Tb, Pb) -> (C, n) reshape can be a layout copy of the
    problem's biggest array, so it must not sit on the hot path.  The
    sharded engine carries the 3-D form (the point axis needs its own
    PartitionSpec) and pays one reshape per use inside shard_map, where the
    operand is the device-local shard.
    """
    oh = bucket.onehot
    if oh.dtype in (jnp.float8_e4m3fn, jnp.float8_e5m2, jnp.int4):
        # float8/int4 refuse implicit promotion; bf16/int8 ride it (the
        # widening convert folds into the dot read — see ba_wtt._ohf).
        oh = oh.astype(bucket.uv.dtype)
    if oh.ndim == 2:
        return oh
    return oh.reshape(oh.shape[0], -1)


def _cam_planes(table: jax.Array, bucket: TTBucket) -> jax.Array:
    """Per-slot camera parameters: (D, Tb, Pb) via one one-hot matmul."""
    tb, pb = bucket.mask.shape
    planes = jnp.einsum("cd,cn->dn", table, _flat_onehot(bucket))
    return planes.reshape(table.shape[1], tb, pb)


def _reduce_to_cams(planes: jax.Array, bucket: TTBucket) -> jax.Array:
    """Sum slot planes (D, Tb, Pb) into per-camera rows (C, D).

    Under point-axis sharding this is the device-local partial sum; callers
    psum the accumulated result once per reduction site.
    """
    d = planes.shape[0]
    return jnp.einsum("dn,cn->cd", planes.reshape(d, -1), _flat_onehot(bucket))


class TTBlocks(NamedTuple):
    r: jax.Array  # (2, Tb, Pb) whitened residual planes
    jc: jax.Array  # (16, Tb, Pb) camera-Jacobian planes (row0 0..7, row1 8..15)
    jp: jax.Array  # (6, Tb, Pb) point-Jacobian planes (row0 0..2, row1 3..5)


def _tt_blocks(
    cam_planes: jax.Array,
    pts_planes: jax.Array,
    uv: jax.Array,
    mask: jax.Array,
    inv_w: jax.Array,
    config: BAConfig,
) -> TTBlocks:
    """Residual/Jacobian planes per slot — identical formulas to
    solvers/ba_grid.grid_blocks (incl. the radial chain A = s I + g m m^T),
    with camera scalars as per-slot planes and the point broadcast free.

    Purely elementwise over the (Tb, Pb) slot table, so the windowed engine
    (solvers/ba_wtt.py) vmaps it over its chunk axis unchanged."""
    dtype = cam_planes.dtype
    cp = cam_planes
    X = pts_planes[0][None, :]
    Y = pts_planes[1][None, :]
    Z = pts_planes[2][None, :]

    x = cp[0] * X + cp[1] * Y + cp[2] * Z + cp[9]
    y = cp[3] * X + cp[4] * Y + cp[5] * Z + cp[10]
    z = cp[6] * X + cp[7] * Y + cp[8] * Z + cp[11]
    z_safe = jnp.where(jnp.abs(z) < 1e-12, jnp.asarray(1.0, dtype), z)
    iz = 1.0 / z_safe
    fx, fy = cp[12], cp[13]
    cx, cy, sk = cp[14], cp[15], cp[16]
    k1, k2 = cp[17], cp[18]

    mx = x * iz
    my = y * iz
    r2 = mx * mx + my * my
    s_rad = 1.0 + k1 * r2 + k2 * r2 * r2
    g_rad = 2.0 * k1 + 4.0 * k2 * r2
    mdx = s_rad * mx
    mdy = s_rad * my

    u = fx * mdx + sk * mdy + cx
    v = fy * mdy + cy
    r0 = u - uv[0]
    r1 = v - uv[1]
    s = r0 * r0 + r1 * r1
    w = robust_weight(config.loss, jax.lax.stop_gradient(s))
    scale = jnp.sqrt(w) * mask * inv_w

    axx = s_rad + g_rad * mx * mx
    axy = g_rad * mx * my
    ayy = s_rad + g_rad * my * my
    b00 = axx * iz
    b01 = axy * iz
    b02 = -(axx * mx + axy * my) * iz
    b10 = axy * iz
    b11 = ayy * iz
    b12 = -(axy * mx + ayy * my) * iz

    a11 = fx * b00 + sk * b10
    a12 = fx * b01 + sk * b11
    a13 = fx * b02 + sk * b12
    a21 = fy * b10
    a22 = fy * b11
    a23 = fy * b12

    jr00 = -a12 * z + a13 * y
    jr01 = a11 * z - a13 * x
    jr02 = -a11 * y + a12 * x
    jr10 = -a22 * z + a23 * y
    jr11 = a21 * z - a23 * x
    jr12 = -a21 * y + a22 * x

    zero = jnp.zeros_like(a11)
    jc_row0 = [jr00, jr01, jr02, a11, a12, a13, mdx, zero]
    jc_row1 = [jr10, jr11, jr12, a21, a22, a23, zero, mdy]
    if config.optimize_dist:
        # d(pi)/dk: u = fx*s*mx + sk*s*my + cx with s = 1 + k1 r2 + k2 r2^2,
        # so du/dk1 = (fx mx + sk my) r2 and du/dk2 = the same * r2.
        du_ds = fx * mx + sk * my
        dv_ds = fy * my
        jc_row0 += [du_ds * r2, du_ds * r2 * r2]
        jc_row1 += [dv_ds * r2, dv_ds * r2 * r2]
    if config.optimize_pp:
        # du/dcx = 1, dv/dcy = 1 (the whitening scale applies below).
        one = jnp.ones_like(a11)
        jc_row0 += [one, zero]
        jc_row1 += [zero, one]
    jc_rows = jc_row0 + jc_row1

    # J_pt = dpi @ R (per-slot rotation planes).
    jp_rows = [
        a11 * cp[0] + a12 * cp[3] + a13 * cp[6],
        a11 * cp[1] + a12 * cp[4] + a13 * cp[7],
        a11 * cp[2] + a12 * cp[5] + a13 * cp[8],
        a21 * cp[0] + a22 * cp[3] + a23 * cp[6],
        a21 * cp[1] + a22 * cp[4] + a23 * cp[7],
        a21 * cp[2] + a22 * cp[5] + a23 * cp[8],
    ]

    if not config.optimize_focal:
        # Zero the focal columns BEFORE the stack (0 * finite scale == 0,
        # value-identical to a post-stack .at[].set) — keeps the whole
        # function scatter-free and purely elementwise.
        jc_rows[6] = zero
        jc_rows[7] = zero
        np_cam = len(jc_row0)
        jc_rows[np_cam + 6] = zero
        jc_rows[np_cam + 7] = zero
    jc = jnp.stack(jc_rows) * scale[None]
    jp = jnp.stack(jp_rows) * scale[None]
    r = jnp.stack([r0, r1]) * scale[None]
    if not config.optimize_points:
        jp = jp * 0.0
    return TTBlocks(r=r, jc=jc, jp=jp)


def _sym3_inv_planes(v: jax.Array) -> jax.Array:
    """Closed-form inverse of symmetric 3x3s in plane form.

    ``v`` holds the 6 components (00, 01, 02, 11, 12, 22) as leading axis;
    returns the inverse in the same packing (same math as schur.inv3x3)."""
    a, b, c, d, e, f = v[0], v[1], v[2], v[3], v[4], v[5]
    co_a = d * f - e * e
    co_b = c * e - b * f
    co_c = b * e - c * d
    det = a * co_a + b * co_b + c * co_c
    det_safe = jnp.where(jnp.abs(det) < 1e-32, 1.0, det)
    inv_det = 1.0 / det_safe
    return jnp.stack(
        [
            co_a * inv_det,
            co_b * inv_det,
            co_c * inv_det,
            (a * f - c * c) * inv_det,
            (b * c - a * e) * inv_det,
            (a * d - b * b) * inv_det,
        ]
    )


def _sym3_matvec(m6: jax.Array, x: jax.Array) -> jax.Array:
    """(3, P) = sym3(m6) @ x with both in plane form."""
    return jnp.stack(
        [
            m6[0] * x[0] + m6[1] * x[1] + m6[2] * x[2],
            m6[1] * x[0] + m6[3] * x[1] + m6[4] * x[2],
            m6[2] * x[0] + m6[4] * x[1] + m6[5] * x[2],
        ]
    )


def _triu_pairs(np_cam: int):
    """Upper-triangle (i, j) pairs in DIAGONAL-major order: all (i, i)
    first, then (i, i+1), ... — so the batched contribution producers can
    slice ``planes[:np-d] * planes[d:]`` per diagonal (zero-copy views)
    instead of gathering per-pair index arrays.  Every producer/consumer
    (the batched contribution forms, ``_unpack_sym``) takes its order
    from this one function, so the order is a private convention."""
    return [(i, i + d) for d in range(np_cam) for i in range(np_cam - d)]


def _triu_idx(triu):
    i_idx = jnp.asarray([i for i, _ in triu])
    j_idx = jnp.asarray([j for _, j in triu])
    return i_idx, j_idx


def _u_g_contribs_batched(jc, r, np_cam: int, triu) -> jax.Array:
    """Stacked (n_triu + np_cam, *slot) contribution planes: U
    upper-triangle (``_triu_pairs`` order) then gradient planes, built from
    batched broadcast multiply-adds instead of an unrolled per-plane
    expression list.

    Program size is why this exists: the unrolled form emits ~165 separate
    HLO subgraphs (with the coupling planes), which dominated BAL-scale
    XLA compile time.  The batched form compiles the same math as a
    handful of multiply+add ops over big tensors.

    The tiny length-2/3 contractions are spelled as EXPLICIT mul+add, not
    einsum: ``jnp.einsum`` lowers them to ``dot_general``s with a 2-wide
    contraction, which matrix units pad badly (measured much slower end to
    end on the accelerator this engine was first built for).  Elementwise
    keeps them fused; the real one-hot reduction downstream is a matmul."""
    assert list(triu) == _triu_pairs(np_cam), (
        "batched contribs hardcode the diagonal-major _triu_pairs order"
    )
    slot = jc.shape[1:]
    jc2 = jc.reshape((2, np_cam) + slot)
    # Diagonal-major pair production (matches _triu_pairs order): slices,
    # not index gathers — gathered operands cost extra memory round trips.
    u = jnp.concatenate([
        jc2[0, : np_cam - d] * jc2[0, d:] + jc2[1, : np_cam - d] * jc2[1, d:]
        for d in range(np_cam)
    ], axis=0)
    g = jc2[0] * r[0][None] + jc2[1] * r[1][None]
    return jnp.concatenate([u, g], axis=0)


def _sym3_rows(v6: jax.Array) -> jax.Array:
    """(3, 3, *v) symmetric matrix view of 6-plane packing (00 01 02 11 12 22)."""
    return v6[jnp.asarray([[0, 1, 2], [1, 3, 4], [2, 4, 5]])]


def _coupling_offdiag_batched(jc, jp, v6b, np_cam: int, triu,
                              want_offdiag: bool):
    """Batched W v_inv W^T planes: the S-diagonal upper-triangle
    (n_triu, *slot) and, when ``want_offdiag``, the adjacent-slot pair
    grid (np, np, *slot[:-2], Tb-1, P) for the band preconditioners.

    Entry (i, j) of a slot is sum_l (W v_inv)[i, l] * W[j, l] with
    W[i, l] = jc[i] jp[l] + jc[np+i] jp[3+l]; the pair grid pairs slot
    (t, p) with (t+1, p) of the same track (track camera lists are strictly
    increasing, so masking with the pair one-hot yields S_{c,c+1} exactly,
    pinned in tests/test_tridiag.py).  ``v6b`` is the 6-plane v_inv shaped
    broadcast-compatible with the slot axes.  All
    tiny contractions are explicit mul+add chains (see
    ``_u_g_contribs_batched`` for why einsum is banned here)."""
    assert list(triu) == _triu_pairs(np_cam), (
        "batched contribs hardcode the diagonal-major _triu_pairs order"
    )
    slot = jc.shape[1:]
    jc2 = jc.reshape((2, np_cam) + slot)
    jp2 = jp.reshape((2, 3) + slot)
    # w[i, l] = sum_a jc2[a, i] * jp2[a, l]  -> (np, 3, *slot)
    w = jc2[0][:, None] * jp2[0][None, :] + jc2[1][:, None] * jp2[1][None, :]
    vi = _sym3_rows(v6b)  # (3, 3, *broadcastable)
    # Right-align vi's slot dims against the full slot rank (einsum's
    # ellipsis did this implicitly; raw broadcasting needs explicit 1s).
    while vi.ndim - 2 < len(slot):
        vi = vi[:, :, None]
    # wv[i, l] = sum_j w[i, j] * vi[j, l]
    wv = (
        w[:, 0:1] * vi[0][None]
        + w[:, 1:2] * vi[1][None]
        + w[:, 2:3] * vi[2][None]
    )
    # coup[(i, j)] = sum_l wv[i, l] * w[j, l], diagonal-major like
    # _triu_pairs — slices, not index gathers.
    coup = jnp.concatenate([
        wv[: np_cam - d, 0] * w[d:, 0]
        + wv[: np_cam - d, 1] * w[d:, 1]
        + wv[: np_cam - d, 2] * w[d:, 2]
        for d in range(np_cam)
    ], axis=0)
    od = None
    if want_offdiag:
        # od[i, j] = sum_l wv[i, l, ..., :-1, :] * w[j, l, ..., 1:, :];
        # accumulated per l so the transient stays (np, np, *slot), not
        # (np, np, 3, *slot).
        wva = wv[..., :-1, :]
        wb = w[..., 1:, :]
        od = wva[:, None, 0] * wb[None, :, 0]
        od = od + wva[:, None, 1] * wb[None, :, 1]
        od = od + wva[:, None, 2] * wb[None, :, 2]
    return coup, od


def _unpack_sym(cols: jax.Array, np_cam: int) -> jax.Array:
    """(C, np(np+1)/2) upper-triangle columns -> (C, np, np) symmetric."""
    C = cols.shape[0]
    i_idx, j_idx = _triu_idx(_triu_pairs(np_cam))
    out = jnp.zeros((C, np_cam, np_cam), cols.dtype)
    out = out.at[:, i_idx, j_idx].set(cols)
    # Mirror below the diagonal (diagonal entries rewrite the same value).
    return out.at[:, j_idx, i_idx].set(cols)


class TTBucketNormal(NamedTuple):
    jc: jax.Array  # (2*np, Tb, Pb) — np = 8, or 10 with optimize_dist
    jp: jax.Array  # (6, Tb, Pb)
    v_inv: jax.Array  # (6, Pb) sym planes
    g_pt: jax.Array  # (3, Pb)
    damp_pt: jax.Array  # (3, Pb)


class TTNormal(NamedTuple):
    u: jax.Array  # (C, np, np) damped
    u_chol: jax.Array  # (C, np, np) cholesky of the preconditioner
    g_cam: jax.Array  # (C, np)
    damp_cam: jax.Array  # (C, np)
    buckets: Tuple[TTBucketNormal, ...]
    tridiag: object = None  # TridiagFactor when config.precond == "tridiag"


def _wt_times_bucket(bn: TTBucketNormal, x_cam: jax.Array, bucket: TTBucket):
    """(W^T x) for one bucket: one one-hot matmul + dense T reductions."""
    tb, pb = bucket.mask.shape
    np_cam = bn.jc.shape[0] // 2
    xg = jnp.einsum("ci,cn->in", x_cam, _flat_onehot(bucket)).reshape(np_cam, tb, pb)
    s0 = sum(bn.jc[i] * xg[i] for i in range(np_cam))
    s1 = sum(bn.jc[np_cam + i] * xg[i] for i in range(np_cam))
    return jnp.stack(
        [
            jnp.sum(bn.jp[0] * s0 + bn.jp[3] * s1, axis=0),
            jnp.sum(bn.jp[1] * s0 + bn.jp[4] * s1, axis=0),
            jnp.sum(bn.jp[2] * s0 + bn.jp[5] * s1, axis=0),
        ]
    )


def _w_times_bucket(bn: TTBucketNormal, y_pt: jax.Array, bucket: TTBucket):
    """(W y) camera rows for one bucket; ``y_pt`` is (3, Pb) planes."""
    s0 = bn.jp[0] * y_pt[0][None] + bn.jp[1] * y_pt[1][None] + bn.jp[2] * y_pt[2][None]
    s1 = bn.jp[3] * y_pt[0][None] + bn.jp[4] * y_pt[1][None] + bn.jp[5] * y_pt[2][None]
    np_cam = bn.jc.shape[0] // 2
    z = jnp.stack([bn.jc[i] * s0 + bn.jc[np_cam + i] * s1 for i in range(np_cam)])
    return _reduce_to_cams(z, bucket)


def _psum(x, axis_name):
    return jax.lax.psum(x, axis_name) if axis_name else x


def _schur_matvec(nb: TTNormal, x_cam: jax.Array, problem, axis_name=None):
    coup = jnp.zeros_like(x_cam)
    for bn, bucket in zip(nb.buckets, problem.buckets):
        wtx = _wt_times_bucket(bn, x_cam, bucket)
        coup = coup + _w_times_bucket(bn, _sym3_matvec(bn.v_inv, wtx), bucket)
    return jnp.einsum("cij,cj->ci", nb.u, x_cam) - _psum(coup, axis_name)


def _linearize(params, lam, problem, config: BAConfig, axis_name=None) -> TTNormal:
    rmats, tvecs, fx_fy, dist, ccs, pts_list = params
    dtype = pts_list[0].dtype
    table = _cam_table(rmats, tvecs, fx_fy, ccs, dist)
    inv_w = (jnp.asarray(1.0, dtype) / problem.avg_cam_width).astype(dtype)

    np_cam = n_cam_params(config)
    use_sj = config.precond in ("schur_jacobi", "tridiag", "ssor")
    triu = _triu_pairs(np_cam)
    n_triu = len(triu)
    u_cols = jnp.zeros((rmats.shape[0], n_triu), dtype)
    g_cols = jnp.zeros((rmats.shape[0], np_cam), dtype)
    coup_cols = jnp.zeros((rmats.shape[0], n_triu), dtype)
    e_cols = jnp.zeros((rmats.shape[0], np_cam * np_cam), dtype)
    bucket_normals = []
    for bucket, pts in zip(problem.buckets, pts_list):
        tb, pb = bucket.mask.shape
        cp = _cam_planes(table, bucket)
        blocks = _tt_blocks(cp, pts, bucket.uv, bucket.mask, inv_w, config)
        jc, jp, r = blocks.jc, blocks.jp, blocks.r

        # Point-side normal: dense over T.
        v6 = jnp.stack(
            [
                jnp.sum(jp[i] * jp[j] + jp[3 + i] * jp[3 + j], axis=0)
                for (i, j) in [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
            ]
        )  # (6, Pb)
        g_pt = jnp.stack(
            [jnp.sum(jp[i] * r[0] + jp[3 + i] * r[1], axis=0) for i in range(3)]
        )
        dv = jnp.clip(v6[jnp.asarray([0, 3, 5])], 1e-8, None)
        damp_pt = lam * dv
        v6_d = v6.at[jnp.asarray([0, 3, 5])].add(damp_pt)
        v_inv = _sym3_inv_planes(v6_d)

        # Camera-side contributions, one fused one-hot reduce:
        # U upper-triangle planes + gradient planes (+ coupling planes).
        # Batched (einsum) plane production — see _u_g_contribs_batched.
        contribs = _u_g_contribs_batched(jc, r, np_cam, triu)
        want_od = config.precond in ("tridiag", "ssor")
        if use_sj:
            # Exact S-diagonal contribution per slot: W v_inv W^T with
            # v_inv broadcast from the point side (free: the table is
            # point-major).
            coup, od = _coupling_offdiag_batched(
                jc, jp, v_inv, np_cam, triu, want_od
            )
            contribs = jnp.concatenate([contribs, coup], axis=0)
        reduced = _reduce_to_cams(contribs, bucket)
        u_cols = u_cols + reduced[:, :n_triu]
        g_cols = g_cols + reduced[:, n_triu : n_triu + np_cam]
        if use_sj:
            coup_cols = coup_cols + reduced[:, n_triu + np_cam : 2 * n_triu + np_cam]
        if want_od:
            # S_{c,c+1} blocks from adjacent-slot pairs: mask the pair
            # planes with the PAIR one-hot (both slots real, cams exactly
            # (c, c+1)) — derived from the existing one-hot by a camera
            # roll, no extra packed storage.
            oh = _flat_onehot(bucket)
            n_cols = oh.shape[1]
            pair_oh = oh[:, : n_cols - pb] * jnp.roll(oh, -1, axis=0)[:, pb:]
            od_flat = od.reshape(np_cam * np_cam, -1)
            e_cols = e_cols + jnp.einsum("kn,cn->ck", od_flat, pair_oh)
        if config.matvec_bf16:
            # Matvec-side planes in bf16 (see BAConfig.matvec_bf16): the
            # f32 jc/jp were already consumed by the reductions above.
            jc, jp = jc.astype(jnp.bfloat16), jp.astype(jnp.bfloat16)
        bucket_normals.append(
            TTBucketNormal(jc=jc, jp=jp, v_inv=v_inv, g_pt=g_pt, damp_pt=damp_pt)
        )

    u_cols = _psum(u_cols, axis_name)
    g_cols = _psum(g_cols, axis_name)
    if use_sj:
        coup_cols = _psum(coup_cols, axis_name)
    u0 = _unpack_sym(u_cols, np_cam)
    g_cam = g_cols
    eye = jnp.eye(np_cam, dtype=dtype)
    du = jnp.clip(jnp.diagonal(u0, axis1=-2, axis2=-1), 1e-8, None)
    damp_cam = lam * du
    u_d = u0 + damp_cam[..., None] * eye
    if use_sj:
        precond_mat = u_d - _unpack_sym(coup_cols, np_cam)
        u_chol = guarded_block_cholesky(precond_mat, u_d)
    else:
        precond_mat = u_d
        u_chol = jax.vmap(jnp.linalg.cholesky)(precond_mat)

    tridiag = None
    if config.precond in ("tridiag", "ssor"):
        from tpu3drecon.solvers.tridiag import (
            auto_segments,
            ssor_factor,
            tridiag_factor,
        )

        e_cols = _psum(e_cols, axis_name)
        e_blocks = -e_cols.reshape(-1, np_cam, np_cam)
        make = ssor_factor if config.precond == "ssor" else tridiag_factor
        tridiag = make(
            precond_mat, e_blocks,
            segments=auto_segments(precond_mat.shape[0]),
        )

    return TTNormal(
        u=u_d,
        u_chol=u_chol,
        g_cam=g_cam,
        damp_cam=damp_cam,
        buckets=tuple(bucket_normals),
        tridiag=tridiag,
    )


def _pcg(nb: TTNormal, b: jax.Array, problem, maxiter, rtol, axis_name=None):
    """PCG on the reduced camera system (shared core: solvers/pcg.py).

    Under sharding the CG state (x, r, z, p) is replicated — only the
    coupling inside ``_schur_matvec`` touches the sharded slot axis, and its
    single psum re-replicates the matvec; all dots are therefore local.
    """
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


def _cost(params, problem, config: BAConfig, axis_name=None) -> jax.Array:
    rmats, tvecs, fx_fy, dist, ccs, pts_list = params
    dtype = pts_list[0].dtype
    table = _cam_table(rmats, tvecs, fx_fy, ccs, dist)
    inv_w = (jnp.asarray(1.0, dtype) / problem.avg_cam_width).astype(dtype)
    total = jnp.zeros((), dtype)
    for bucket, pts in zip(problem.buckets, pts_list):
        cp = _cam_planes(table, bucket)
        x = cp[0] * pts[0][None] + cp[1] * pts[1][None] + cp[2] * pts[2][None] + cp[9]
        y = cp[3] * pts[0][None] + cp[4] * pts[1][None] + cp[5] * pts[2][None] + cp[10]
        z = cp[6] * pts[0][None] + cp[7] * pts[1][None] + cp[8] * pts[2][None] + cp[11]
        iz = 1.0 / jnp.where(jnp.abs(z) < 1e-12, jnp.asarray(1.0, dtype), z)
        mx = x * iz
        my = y * iz
        r2 = mx * mx + my * my
        s_rad = 1.0 + cp[17] * r2 + cp[18] * r2 * r2
        u = cp[12] * s_rad * mx + cp[16] * s_rad * my + cp[14]
        v = cp[13] * s_rad * my + cp[15]
        r0 = u - bucket.uv[0]
        r1 = v - bucket.uv[1]
        s = r0 * r0 + r1 * r1
        w = robust_weight(config.loss, jax.lax.stop_gradient(s))
        total = total + 0.5 * jnp.sum(s * w * (bucket.mask * inv_w) ** 2)
    return _psum(total, axis_name)


def ba_solve_tt(
    problem: BATTProblem, config: BAConfig = BAConfig(),
) -> Tuple[CameraParams, jax.Array, BAState]:
    """Track-table BA solve; same (cameras, points, BAState) outputs and the
    same trust-region trajectory as ba_solve/ba_solve_grid."""
    with jax.default_matmul_precision("highest"):
        pts_list = []
        for bucket, off in zip(problem.buckets, problem.bucket_offsets):
            pb = bucket.mask.shape[1]
            pts_list.append(problem.points3d[off : off + pb].T)  # (3, Pb)
        cams, pts_out, final = _ba_solve_tt_core(problem, tuple(pts_list), config)
        points3d = jnp.concatenate([p.T for p in pts_out], axis=0)
        pts = unpermute_points(points3d, problem)
        state = _tt_state(cams, pts, final)
        return cams, pts, state


def _tt_state(cams: CameraParams, points3d: jax.Array, final) -> BAState:
    return BAState(
        rmats=cams.rmats, tvecs=cams.tvecs, fx_fy=cams.fx_fy,
        points3d=points3d, loss=final.loss, lam=final.lam, nu=final.nu,
        iter_num=final.iter_num, accepted=final.accepted,
        grad_norm=final.grad_norm, converged=final.converged,
        cg_iters=final.cg_iters, gain=final.gain,
    )


def _ba_solve_tt_core(problem, pts_list, config: BAConfig, axis_name=None):
    """Shared solve body: single-chip (axis_name=None) and the SPMD path.

    ``problem`` only needs .cameras / .buckets / .avg_cam_width here; under
    shard_map the buckets and ``pts_list`` planes are the device-local
    point-axis shards while the camera table stays replicated, so every
    point-side quantity (V, v_inv, g_pt, back-substitution) is local and the
    only collectives are the tiny (C, np)-sized psums at the camera reduces.
    """
    cams = problem.cameras
    dtype = pts_list[0].dtype
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
            vw = _sym3_matvec(bn.v_inv, bn.g_pt)
            b = b + _w_times_bucket(bn, vw, bucket)
        b = _psum(b, axis_name) - nb.g_cam
        dc, cg_iters = _pcg(
            nb, b, problem, config.cg_maxiter, config.cg_rtol, axis_name,
        )

        dps = []
        pred_pt = jnp.zeros((), dtype)
        for bn, bucket in zip(nb.buckets, problem.buckets):
            wtx = _wt_times_bucket(bn, dc, bucket)
            dp = _sym3_matvec(bn.v_inv, -bn.g_pt - wtx)  # (3, Pb)
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
        dc, dps = delta
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


_TT_SOLVER_CACHE: dict = {}
_TT_JIT_CACHE: dict = {}


def make_tt_ba_solver(config: BAConfig = BAConfig()):
    """Jitted tt solver (cached).  Loop bounds/tolerances ride in as
    dynamic operands, so configs that differ only in those share one
    compiled executable."""
    if config not in _TT_SOLVER_CACHE:
        from tpu3drecon.solvers.bundle_adjust import (
            dynamic_operands,
            merge_dynamic_config,
            static_config,
        )

        static = static_config(config)
        jfn = _TT_JIT_CACHE.get(static)
        if jfn is None:
            jfn = jax.jit(
                lambda p, d, s=static: ba_solve_tt(p, merge_dynamic_config(s, d))
            )
            _TT_JIT_CACHE[static] = jfn
        _TT_SOLVER_CACHE[config] = lambda p, _j=jfn, _c=config: _j(
            p, dynamic_operands(_c)
        )
    return _TT_SOLVER_CACHE[config]
