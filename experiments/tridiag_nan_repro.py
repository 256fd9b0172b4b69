"""Repro: wtt tridiag preconditioner NaN at BAL-like scale in f32.

CPU, f32 (matching the accelerator run's numerics), sequential scene at a reduced
BAL ratio; builds the wtt normal equations at the initial point and checks
the tridiag factor + preconditioner apply for non-finite values, plus the
E-block construction against a probed Schur matvec.

Usage: python experiments/tridiag_nan_repro.py [n_cams] [lam]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from tpu3drecon.dataset.synthetic import (
    make_sequential_scene,
    perturb_scene,
    scene_to_ba_problem,
)
from tpu3drecon.problems.wtt import wtt_from_flat
from tpu3drecon.solvers import ba_wtt
from tpu3drecon.solvers.bundle_adjust import BAConfig
from tpu3drecon.solvers.tridiag import auto_segments, tridiag_solve

n_cams = int(sys.argv[1]) if len(sys.argv) > 1 else 256
lam_val = float(sys.argv[2]) if len(sys.argv) > 2 else 1e-3

scene = make_sequential_scene(
    n_cameras=n_cams, points_per_camera=584, track_span=4, seed=7
)
noisy = perturb_scene(scene, seed=8, point2d_noise=0.5)
flat, _ = scene_to_ba_problem(noisy, observed=scene, dtype=jnp.float32)
wtt = wtt_from_flat(flat, point_chunk=512)
print("buckets:", [(tuple(b.uv.shape), int(b.window)) for b in wtt.buckets],
      "c_pad", wtt.c_pad, flush=True)

config = BAConfig(maxiter=3, gtol=0.0, ftol=0.0, cg_maxiter=30,
                  cg_rtol=1e-6, precond="tridiag")

with jax.default_matmul_precision("highest"):
    pts_list = []
    for bucket, off in zip(wtt.buckets, wtt.bucket_offsets):
        g, _, tb, pc = bucket.uv.shape
        block = wtt.points3d[off : off + g * pc]
        pts_list.append(jnp.moveaxis(block.reshape(g, pc, 3), 2, 0))
    cams = wtt.cameras
    params = (cams.rmats, cams.tvecs, cams.fx_fy, cams.dist,
              cams.cx_cy_skew, tuple(pts_list))
    lam = jnp.asarray(lam_val, jnp.float32)
    nb = ba_wtt._linearize(params, lam, wtt, config)

    seg = auto_segments(wtt.c_pad)
    print("segments:", seg, flush=True)
    f = nb.tridiag
    for name, arr in (("l", f.l_blocks), ("w", f.w_blocks),
                      ("wu", f.w_used)):
        finite = bool(jnp.all(jnp.isfinite(arr)))
        print(f"factor {name}: finite={finite} "
              f"max|.|={float(jnp.max(jnp.abs(jnp.nan_to_num(arr, nan=0.0, posinf=0.0, neginf=0.0)))):.3e}",
              flush=True)
        if not finite:
            bad = np.unique(np.nonzero(~np.isfinite(np.asarray(arr)))[0])
            print(f"  non-finite rows (cameras): {bad[:20]} ... n={len(bad)}")

    # b vector as the solver builds it
    b = jnp.zeros_like(nb.g_cam)
    for bn, bucket in zip(nb.buckets, wtt.buckets):
        vw = ba_wtt._sym3_matvec_g(bn.v_inv, bn.g_pt)
        b = b + ba_wtt._w_times_bucket_w(bn, vw, bucket, wtt.c_pad)
    b = b - nb.g_cam
    z0 = tridiag_solve(f, b, segments=seg)
    print("b finite:", bool(jnp.all(jnp.isfinite(b))),
          "z0 finite:", bool(jnp.all(jnp.isfinite(z0))), flush=True)

    # E-block correctness: probe S with unit vectors at a few cameras and
    # compare S_{c,c+1} against the stored e_blocks via tridiag pieces is
    # indirect; instead compare the preconditioner matvec M = D + E + E^T
    # against the true S on the tridiagonal band via random probes.
    np_cam = nb.g_cam.shape[1]
    rng = np.random.default_rng(0)
    # re-derive the raw blocks the factor was built from
    # (re-run the relevant part of _linearize): use the public pieces
    # stored on nb: u (damped diag), tridiag factor. Instead probe:
    def smat(x):
        return ba_wtt._schur_matvec(nb, x, wtt, None)

    for c in [3, n_cams // 2, n_cams - 2]:
        x = jnp.zeros((wtt.c_pad, np_cam), jnp.float32)
        x = x.at[c + 1, :].set(jnp.asarray(rng.standard_normal(np_cam),
                                            jnp.float32))
        sx = smat(x)
        # M x rows c and c+1 from the factor is awkward; instead recompute
        # e via finite probe: S_{c,c+1} v = row c of S x.
        print(f"probe cam {c}: |S_(c,c+1) v| = "
              f"{float(jnp.linalg.norm(sx[c])):.4e}, "
              f"|S_(c+1,c+1) v| = {float(jnp.linalg.norm(sx[c+1])):.4e}",
              flush=True)
