"""Pinhole + polynomial-radial projection and residuals (pure jnp, batched).

Array-level replacement for the reference's per-object ``Camera.project``
(reference: src/dataset/camera.py:57-64) and the residual pipelines in
src/reconstruction/bundle_adjustment/{pose_optimization.py:33-52,
bundle_adjustment.py:17-29}.  Intrinsics follow the same K layout with frozen
cx/cy/skew and optimizable fx/fy, extended with a per-camera radial
distortion pair ``dist = (k1, k2)`` applied to NORMALIZED coordinates:

    m  = (x/z, y/z)
    m' = (1 + k1 |m|^2 + k2 |m|^4) * m
    (u, v) = K2 m' + (cx, cy)

This covers BAL's camera model (k1, k2) and COLMAP's SIMPLE_RADIAL (k -> (k, 0))
and RADIAL (k1, k2) exactly (reference loader ingests SIMPLE_RADIAL at
src/dataset/loaders/colmap_dataset_loader/loader.py:32-41); dist = (0, 0) is
the pure pinhole special case.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def make_intrinsics_matrix(fx_fy: jax.Array, cx_cy_skew: jax.Array) -> jax.Array:
    """Assemble K from optimizable (fx, fy) and frozen (cx, cy, skew).

    Mirrors reference utils.parse_intrinsics (utils.py:47-57): K =
    [[fx, skew, cx], [0, fy, cy], [0, 0, 1]].
    """
    dtype = fx_fy.dtype
    z = jnp.zeros((), dtype)
    o = jnp.ones((), dtype)
    return jnp.array(
        [
            [fx_fy[0], cx_cy_skew[2], cx_cy_skew[0]],
            [z, fx_fy[1], cx_cy_skew[1]],
            [z, z, o],
        ]
    )


def world_to_camera(rmat: jax.Array, tvec: jax.Array, xyz: jax.Array) -> jax.Array:
    """World point -> camera-frame point for a W2C extrinsic (R, t).

    Explicit HIGHEST precision: this also runs on eval/output paths outside
    any default_matmul_precision scope, where a reduced-precision f32
    matmul default (TF32 on the H100) would cost whole pixels of
    projection accuracy."""
    return jnp.matmul(rmat, xyz, precision=jax.lax.Precision.HIGHEST) + tvec


def radial_factor(m: jax.Array, dist: jax.Array) -> jax.Array:
    """Polynomial radial scale s(m) = 1 + k1 r^2 + k2 r^4 on normalized m."""
    r2 = jnp.sum(m * m, axis=-1)
    return 1.0 + dist[0] * r2 + dist[1] * r2 * r2


def perspective_project(
    xyz_cam: jax.Array, fx_fy: jax.Array, cx_cy_skew: jax.Array, dist: jax.Array
) -> jax.Array:
    """Camera-frame point -> pixel coordinates (perspective divide + radial).

    The divide is guarded (same z_safe used by ops/jacobians.py and ba_grid):
    padded rows carry (0,0,0) points whose z would otherwise produce inf, and
    inf * 0-mask = NaN would poison the whole batched loss — the guard keeps
    the padded-rows-contribute-exact-zeros invariant.
    """
    z = xyz_cam[2]
    z_safe = jnp.where(jnp.abs(z) < 1e-12, jnp.ones((), z.dtype), z)
    inv_z = 1.0 / z_safe
    m = xyz_cam[:2] * inv_z
    md = radial_factor(m, dist) * m
    u = fx_fy[0] * md[0] + cx_cy_skew[2] * md[1] + cx_cy_skew[0]
    v = fx_fy[1] * md[1] + cx_cy_skew[1]
    return jnp.stack([u, v])


def project_point(
    rmat: jax.Array,
    tvec: jax.Array,
    fx_fy: jax.Array,
    cx_cy_skew: jax.Array,
    dist: jax.Array,
    xyz: jax.Array,
) -> jax.Array:
    """Full projection of one world point through one W2C camera."""
    return perspective_project(
        world_to_camera(rmat, tvec, xyz), fx_fy, cx_cy_skew, dist
    )


# vmap over points (camera fixed).
project_points = jax.vmap(project_point, in_axes=(None, None, None, None, None, 0))

# vmap over cameras AND their own point sets:
# (B,3,3),(B,3),(B,2),(B,3),(B,2),(B,N,3).
project_points_batched = jax.vmap(project_points, in_axes=(0, 0, 0, 0, 0, 0))


def reprojection_residuals(
    rmat: jax.Array,
    tvec: jax.Array,
    fx_fy: jax.Array,
    cx_cy_skew: jax.Array,
    dist: jax.Array,
    points3d: jax.Array,
    points2d: jax.Array,
    mask: jax.Array,
) -> jax.Array:
    """Masked per-axis reprojection residuals (N, 2) for one camera.

    Padded entries (mask == 0) contribute exact zeros to residual and (by the
    chain rule) to any Jacobian/JtJ built from them — fixing the reference's
    repeat-element-0 padding subtlety (benchmark_bundle_adjustment.py:81-84).
    """
    projected = project_points(rmat, tvec, fx_fy, cx_cy_skew, dist, points3d)
    return (projected - points2d) * mask[:, None]
