"""Sharded bucketed-grid BA: the fast engine under a device mesh.

Round-1 sharded BA (parallel/sharded_ba.py) shards the observation axis of
the FLAT engine and psum-replicates everything point-sized — ~48 MB of
all-reduce per outer iteration at BAL scale and redundant per-device point
math.  This module shards the bucketed GRID engine (the fast single-chip
layout) along BOTH structural axes instead:

  - CAMERA axis: each device owns C/D contiguous grid rows — their uv /
    pt_idx / mask planes, jc/jp/r planes, U blocks, gradients, the CG state,
    and the camera parameters themselves;
  - POINT axis: each device owns Pb/D contiguous rows of every track bucket —
    their gathered jp rows, V blocks, v_inv, g_pt, and the back-substituted
    dp.  Nothing O(P) is ever psum-replicated.

Only points3d (P x 3, the smallest O(P) array) is replicated, because every
camera shard projects arbitrary points.  Per CG iteration the transport
between the two axes is two all_gathers riding ICI:

    s   (C*K complex64)  camera -> point side   [matvec W^T half]
    y   (P x 3)          point -> camera side   [matvec W half]

and per linearization: the packed [jp|r] obs rows (camera -> point side),
dp (point -> camera side), and v_inv for the SCHUR_JACOBI preconditioner.
All trust-region scalars are psum/pmax-reduced, so every device steps in
lockstep (same guarantee as sharded_ba).

SURVEY.md §5 distributed mapping: "block the point axis for the Schur
solve" — this is that design.  Step-equivalence with the single-device grid
engine is asserted in tests/test_sharded_grid.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu3drecon.parallel.mesh import mesh_key
from tpu3drecon.problems.grid import BAGridBucketedProblem, TrackBucket, unpermute_points
from tpu3drecon.problems.packing import CameraParams
from tpu3drecon.solvers.ba_grid import grid_blocks
from tpu3drecon.solvers.bundle_adjust import BAConfig, BAState
from tpu3drecon.solvers.schur import inv3x3
from tpu3drecon.solvers.trust_region import trust_region_solve

SHARD_AXIS = "shard"


def pad_cameras_for_mesh(
    problem: BAGridBucketedProblem, n_devices: int
) -> BAGridBucketedProblem:
    """Pad the camera axis to a multiple of the mesh size.

    Padding rows get identity rotations, z-offset translations and unit
    focals with all-zero observation masks: they contribute exact zeros
    everywhere and their LM steps are exactly zero.
    """
    c = problem.n_cameras
    pad = (-c) % n_devices
    if pad == 0:
        return problem
    k = problem.uv.shape[1]
    dtype = problem.uv.dtype
    cams = problem.cameras
    eye = jnp.tile(jnp.eye(3, dtype=dtype)[None], (pad, 1, 1))
    new_cams = CameraParams(
        rmats=jnp.concatenate([cams.rmats, eye]),
        tvecs=jnp.concatenate([cams.tvecs, jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], dtype), (pad, 1))]),
        fx_fy=jnp.concatenate([cams.fx_fy, jnp.ones((pad, 2), dtype)]),
        cx_cy_skew=jnp.concatenate([cams.cx_cy_skew, jnp.zeros((pad, 3), dtype)]),
        dist=jnp.concatenate([cams.dist, jnp.zeros((pad, 2), dtype)]),
    )
    return dataclasses.replace(
        problem,
        cameras=new_cams,
        uv=jnp.concatenate([problem.uv, jnp.zeros((pad, k, 2), dtype)]),
        pt_idx=jnp.concatenate([problem.pt_idx, jnp.zeros((pad, k), jnp.int32)]),
        mask=jnp.concatenate([problem.mask, jnp.zeros((pad, k), dtype)]),
    )


def shard_grid_problem(
    problem: BAGridBucketedProblem, mesh: Mesh, axis_name: str = SHARD_AXIS
) -> BAGridBucketedProblem:
    """Place a bucketed grid problem on the mesh: camera axis sharded for the
    grid planes + camera params, point axis sharded for every track bucket,
    points3d replicated.  Bucket point counts are multiples of the 512-row
    point block, so any power-of-two mesh divides them."""
    problem = pad_cameras_for_mesh(problem, mesh.devices.size)
    cam = NamedSharding(mesh, P(axis_name))
    rep = NamedSharding(mesh, P())
    from tpu3drecon.utils.placement import sharded_put as put
    return dataclasses.replace(
        problem,
        cameras=CameraParams(
            rmats=put(problem.cameras.rmats, cam),
            tvecs=put(problem.cameras.tvecs, cam),
            fx_fy=put(problem.cameras.fx_fy, cam),
            cx_cy_skew=put(problem.cameras.cx_cy_skew, cam),
            dist=put(problem.cameras.dist, cam),
        ),
        points3d=put(problem.points3d, rep),
        uv=put(problem.uv, cam),
        pt_idx=put(problem.pt_idx, cam),
        mask=put(problem.mask, cam),
        buckets=tuple(
            TrackBucket(
                track_idx=put(b.track_idx, cam),
                track_cam=put(b.track_cam, cam),
                track_mask=put(b.track_mask, cam),
            )
            for b in problem.buckets
        ),
        avg_cam_width=put(problem.avg_cam_width, rep),
        point_rows=put(problem.point_rows, rep),
    )


class _ShardNormal:
    """Per-device linearization state (plain attrs; lives inside shard_map)."""

    def __init__(self, u, u_chol, g_cam, jc, jp, buckets_jp_g, v_inv, g_pt,
                 damp_cam, damp_pt):
        self.u = u
        self.u_chol = u_chol
        self.g_cam = g_cam
        self.jc = jc
        self.jp = jp
        self.buckets_jp_g = buckets_jp_g
        self.v_inv = v_inv
        self.g_pt = g_pt
        self.damp_cam = damp_cam
        self.damp_pt = damp_pt


def _local_grid_view(problem, uv, pt_idx, mask):
    """A minimal object with the fields grid_blocks reads."""

    class V:  # noqa: N801 - throwaway view
        pass

    v = V()
    v.uv = uv
    v.pt_idx = pt_idx
    v.mask = mask
    v.avg_cam_width = problem.avg_cam_width
    return v


def ba_solve_grid_sharded(
    problem: BAGridBucketedProblem,
    config: BAConfig = BAConfig(),
    mesh: Optional[Mesh] = None,
    axis_name: Optional[str] = None,
) -> Tuple[CameraParams, jax.Array, BAState]:
    """Sharded bucketed-grid BA solve; replicated outputs matching
    ba_solve_grid (points un-permuted)."""
    if mesh is None:
        from tpu3drecon.parallel.mesh import make_mesh

        mesh = make_mesh(axis_name=axis_name or SHARD_AXIS)
    axis_name = axis_name or mesh.axis_names[0]
    placed = shard_grid_problem(problem, mesh, axis_name)
    solver = make_sharded_grid_solver(mesh, config, axis_name, type(placed))
    cams, pts, state = solver(placed)
    pts = unpermute_points(pts, placed)
    state = state._replace(points3d=pts)
    return cams, pts, state


_SHARDED_GRID_CACHE: dict = {}


def make_sharded_grid_solver(
    mesh: Mesh, config: BAConfig = BAConfig(), axis_name: str = SHARD_AXIS,
    problem_type=BAGridBucketedProblem,
):
    """Jitted shard_map solver for a mesh + config (cached); each device
    runs the grid-engine plane math on its shard."""
    from tpu3drecon.solvers.bundle_adjust import (
        DynamicBAParams,
        merge_dynamic_config,
        split_dynamic_config,
    )

    static, dyn = split_dynamic_config(config)
    key = (mesh_key(mesh), static, axis_name)
    if key in _SHARDED_GRID_CACHE:
        jfn = _SHARDED_GRID_CACHE[key]
        return lambda placed, _j=jfn, _d=dyn: _j(placed, _d)

    cam = P(axis_name)
    rep = P()

    def problem_specs(n_buckets: int, n_real_points: int):
        # NOTE: n_real_points is a static pytree field — the spec pytree must
        # carry the same value or shard_map's treedef match fails.
        return BAGridBucketedProblem(
            cameras=CameraParams(rmats=cam, tvecs=cam, fx_fy=cam, cx_cy_skew=cam, dist=cam),
            points3d=rep,
            uv=cam,
            pt_idx=cam,
            mask=cam,
            buckets=tuple(
                TrackBucket(track_idx=cam, track_cam=cam, track_mask=cam)
                for _ in range(n_buckets)
            ),
            avg_cam_width=rep,
            point_rows=rep,
            n_real_points=n_real_points,
        )

    def solve(placed, dyn_in):
        n_buckets = len(placed.buckets)

        def local(problem, d):
            return _solve_local(
                problem, config=merge_dynamic_config(static, d),
                axis_name=axis_name,
            )
        out_specs = (
            CameraParams(rmats=rep, tvecs=rep, fx_fy=rep, cx_cy_skew=rep, dist=rep),
            rep,
            BAState(
                rmats=rep, tvecs=rep, fx_fy=rep, points3d=rep, loss=rep,
                lam=rep, nu=rep, iter_num=rep, accepted=rep, grad_norm=rep,
                converged=rep, cg_iters=rep, gain=rep,
            ),
        )
        rep_dyn = DynamicBAParams(*(P() for _ in DynamicBAParams._fields))
        sharded = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(problem_specs(n_buckets, placed.n_real_points), rep_dyn),
            out_specs=out_specs,
            check_vma=False,
        )
        with jax.default_matmul_precision("highest"):
            return sharded(placed, dyn_in)

    jfn = jax.jit(solve)
    _SHARDED_GRID_CACHE[key] = jfn
    return lambda placed, _j=jfn, _d=dyn: _j(placed, _d)


def _solve_local(problem, *, config: BAConfig, axis_name: str):
    """Per-device solve body (runs inside shard_map on local shards)."""
    cams = problem.cameras  # camera-axis LOCAL shard
    dtype = problem.points3d.dtype
    k = problem.uv.shape[1]

    def psum(x):
        return jax.lax.psum(x, axis_name)

    def pmax(x):
        return jax.lax.pmax(x, axis_name)

    def allgather(x):
        # tiled=True concatenates device blocks in mesh order — matching the
        # contiguous-block PartitionSpec placement, so indices stay global.
        return jax.lax.all_gather(x, axis_name, axis=0, tiled=True)

    # Local point vectors concatenate the LOCAL rows of each bucket, but the
    # GLOBAL point layout is [bucket0 | bucket1 | ...]: a single tiled
    # all_gather would interleave device blocks across buckets.  Gather each
    # bucket's rows separately and re-concatenate in global order.
    local_bucket_sizes = tuple(b.track_idx.shape[0] for b in problem.buckets)

    def gather_points(x_local):
        parts, off = [], 0
        for n in local_bucket_sizes:
            parts.append(allgather(x_local[off : off + n]))
            off += n
        return jnp.concatenate(parts)

    def blocks_for(rmats, tvecs, fx_fy, points3d_full):
        view = _local_grid_view(problem, problem.uv, problem.pt_idx, problem.mask)
        b = grid_blocks(
            rmats, tvecs, fx_fy, cams.cx_cy_skew, cams.dist,
            points3d_full, view, config.loss,
        )
        jc, jp = b.jc, b.jp
        if not config.optimize_focal:
            jc = jc.at[..., 6:8].set(0.0)
        if not config.optimize_points:
            jp = jp * 0.0
        return b._replace(jc=jc, jp=jp)

    def linearize(params, lam):
        rmats, tvecs, fx_fy, points3d_full = params
        b = blocks_for(rmats, tvecs, fx_fy, points3d_full)
        c_l = b.jc.shape[0]
        # Camera side: local dense reductions.
        jc2 = b.jc.reshape(c_l, k * 2, 8)
        r2 = b.r.reshape(c_l, k * 2)
        u = jnp.einsum("cni,cnj->cij", jc2, jc2)
        g_cam = jnp.einsum("cni,cn->ci", jc2, r2)

        # Transport packed [jp | r] rows to the point shards.
        jp_rows = b.jp.reshape(c_l * k, 6)
        r_rows = b.r.reshape(c_l * k, 2)
        jpr_local = jnp.concatenate([jp_rows, r_rows], axis=1)  # (c_l*k, 8)
        jpr_full = allgather(jpr_local)  # (C*k, 8) global flat rows

        buckets_jp_g = []
        v_parts, g_parts = [], []
        for bucket in problem.buckets:  # point-axis LOCAL shards
            pb, tb = bucket.track_idx.shape
            tm = bucket.track_mask[..., None]
            jpr_g = jpr_full[bucket.track_idx] * tm  # (pb, tb, 8)
            jp_g = jpr_g[..., :6].reshape(pb, tb * 2, 3)
            r_g = jpr_g[..., 6:8].reshape(pb, tb * 2)
            # Tiny 3x3 outputs: broadcast-product + reduce, not batched
            # micro-dots (layout trap, RESULTS.md).
            v = jnp.sum(jp_g[..., :, None] * jp_g[..., None, :], axis=1)
            g_pt = jnp.sum(jp_g * r_g[..., None], axis=1)
            buckets_jp_g.append(jp_g)
            v_parts.append(v)
            g_parts.append(g_pt)
        v = jnp.concatenate(v_parts)
        g_pt = jnp.concatenate(g_parts)

        eye8 = jnp.eye(8, dtype=dtype)
        eye3 = jnp.eye(3, dtype=dtype)
        du = jnp.clip(jnp.diagonal(u, axis1=-2, axis2=-1), 1e-8, None)
        dv = jnp.clip(jnp.diagonal(v, axis1=-2, axis2=-1), 1e-8, None)
        damp_cam = lam * du
        damp_pt = lam * dv
        u_d = u + damp_cam[..., None] * eye8
        v_d = v + damp_pt[..., None] * eye3
        v_inv = inv3x3(v_d)  # point-axis LOCAL

        if config.precond == "schur_jacobi":
            # v_inv for the local camera rows' points: one all_gather per
            # linearization (the camera shard references arbitrary points).
            vinv_full = gather_points(v_inv.reshape(-1, 9)).reshape(-1, 3, 3)
            w_cell = (
                b.jc[..., 0, :, None] * b.jp[..., 0, None, :]
                + b.jc[..., 1, :, None] * b.jp[..., 1, None, :]
            )
            vinv_g = vinv_full[problem.pt_idx]
            wv = (
                w_cell[..., 0, None] * vinv_g[..., None, 0, :]
                + w_cell[..., 1, None] * vinv_g[..., None, 1, :]
                + w_cell[..., 2, None] * vinv_g[..., None, 2, :]
            )
            coupling = jnp.einsum("ckil,ckml->cim", wv, w_cell)
            precond_mat = u_d - coupling
        else:
            precond_mat = u_d
        u_chol = jax.vmap(jnp.linalg.cholesky)(precond_mat)

        return _ShardNormal(
            u=u_d, u_chol=u_chol, g_cam=g_cam, jc=b.jc, jp=b.jp,
            buckets_jp_g=buckets_jp_g, v_inv=v_inv, g_pt=g_pt,
            damp_cam=damp_cam, damp_pt=damp_pt,
        )

    def wt_times(nb, x_local):
        """(W^T x) on the local point shard: all_gather the per-obs pair.

        Payload stays f32 (2 floats/row): complex64 packing would halve the
        collective bytes but the LOCAL gather of complex64 hit XLA's slow
        path on the first accelerator.
        """
        c_l = nb.jc.shape[0]
        s = jnp.sum(nb.jc * x_local[:, None, None, :], axis=-1)  # (c_l, k, 2)
        s_full = allgather(s.reshape(c_l * k, 2))
        parts = []
        off = 0
        for bucket, jp_g in zip(problem.buckets, nb.buckets_jp_g):
            pb, tb = bucket.track_idx.shape
            s_g = (s_full[bucket.track_idx] * bucket.track_mask[..., None]).reshape(
                pb, tb * 2
            )
            parts.append(jnp.sum(jp_g * s_g[..., None], axis=1))
            off += pb
        return jnp.concatenate(parts)  # point-axis LOCAL (sum over all cams)

    def w_times(nb, y_local):
        """(W y) on the local camera rows: all_gather y across point shards."""
        y_full = gather_points(y_local)  # (P, 3) in GLOBAL point order
        y_g = y_full[problem.pt_idx]  # (c_l, k, 3)
        tmp = jnp.sum(nb.jp * y_g[:, :, None, :], axis=-1)
        return jnp.einsum("ckri,ckr->ci", nb.jc, tmp)

    def schur_matvec(nb, x_local):
        ux = jnp.sum(nb.u * x_local[:, None, :], axis=-1)
        wtx = wt_times(nb, x_local)
        vinv_wtx = jnp.sum(nb.v_inv * wtx[:, None, :], axis=-1)
        return ux - w_times(nb, vinv_wtx)

    def pcg(nb, b_local):
        def dot(a, b_):
            return psum(jnp.sum(a * b_))

        def precond(r):
            return jax.vmap(
                lambda ch, rr: jax.scipy.linalg.cho_solve((ch, True), rr)
            )(nb.u_chol, r)

        z0 = precond(b_local)
        rz0 = dot(b_local, z0)
        tol2 = jnp.asarray(config.cg_rtol, dtype) ** 2 * jnp.maximum(
            dot(b_local, b_local), 1e-32
        )

        def cond(st):
            _, r, _, _, _, i = st
            return jnp.logical_and(i < config.cg_maxiter, dot(r, r) > tol2)

        def body(st):
            x, r, z, p, rz, i = st
            sp = schur_matvec(nb, p)
            psp = dot(p, sp)
            alpha = rz / jnp.where(jnp.abs(psp) < 1e-32, 1.0, psp)
            x = x + alpha * p
            r = r - alpha * sp
            z = precond(r)
            rz_new = dot(r, z)
            beta = rz_new / jnp.where(jnp.abs(rz) < 1e-32, 1.0, rz)
            return (x, r, z, z + beta * p, rz_new, i + 1)

        x, _, _, _, _, iters = jax.lax.while_loop(
            cond, body,
            (jnp.zeros_like(b_local), b_local, z0, z0, rz0, jnp.zeros((), jnp.int32)),
        )
        return x, iters

    def propose(params, lam):
        nb = linearize(params, lam)
        grad_norm = pmax(
            jnp.maximum(
                jnp.max(jnp.abs(nb.g_cam)),
                jnp.max(jnp.abs(nb.g_pt)) if config.optimize_points else 0.0,
            )
        )
        vinv_gp = jnp.sum(nb.v_inv * nb.g_pt[:, None, :], axis=-1)
        b = -nb.g_cam + w_times(nb, vinv_gp)
        dc, cg_iters = pcg(nb, b)
        dp_local = jnp.sum(
            nb.v_inv * (-nb.g_pt - wt_times(nb, dc))[:, None, :], axis=-1
        )
        if not config.optimize_points:
            dp_local = dp_local * 0.0
        pred = 0.5 * (
            psum(jnp.sum(dc * (nb.damp_cam * dc)))
            + psum(jnp.sum(dp_local * (nb.damp_pt * dp_local)))
            - psum(jnp.sum(dc * nb.g_cam))
            - psum(jnp.sum(dp_local * nb.g_pt))
        )
        return (dc, dp_local), grad_norm, pred, cg_iters

    def apply_step(params, delta):
        from tpu3drecon.ops.jacobians import apply_se3_retraction

        rmats, tvecs, fx_fy, points3d_full = params
        dc, dp_local = delta
        new_r, new_t, new_f = apply_se3_retraction(rmats, tvecs, fx_fy, dc)
        dp_full = gather_points(dp_local)
        return (new_r, new_t, new_f, points3d_full + dp_full)

    def cost(params):
        rmats, tvecs, fx_fy, points3d_full = params
        b = blocks_for(rmats, tvecs, fx_fy, points3d_full)
        return psum(0.5 * jnp.sum(b.r * b.r))

    params0 = (cams.rmats, cams.tvecs, cams.fx_fy, problem.points3d)
    final = trust_region_solve(propose, apply_step, cost, params0, config, dtype)
    rmats_l, tvecs_l, fx_fy_l, points3d_full = final.params

    # Replicate camera outputs (small).
    def gather_cams(x):
        return jax.lax.all_gather(x, axis_name, axis=0, tiled=True)

    cameras_out = CameraParams(
        rmats=gather_cams(rmats_l),
        tvecs=gather_cams(tvecs_l),
        fx_fy=gather_cams(fx_fy_l),
        cx_cy_skew=gather_cams(cams.cx_cy_skew),
        dist=gather_cams(cams.dist),
    )
    state = BAState(
        rmats=cameras_out.rmats,
        tvecs=cameras_out.tvecs,
        fx_fy=cameras_out.fx_fy,
        points3d=points3d_full,
        loss=final.loss,
        lam=final.lam,
        nu=final.nu,
        iter_num=final.iter_num,
        accepted=final.accepted,
        grad_norm=final.grad_norm,
        converged=final.converged,
        cg_iters=final.cg_iters,
        gain=final.gain,
    )
    return cameras_out, points3d_full, state
