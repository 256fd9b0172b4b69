"""Rotation algebra: Rodrigues vectors, quaternions, rotation matrices.

Accelerator-side replacement for the reference's mix of scipy ``Rotation`` objects
(reference: src/dataset/camera_pose/camera_pose.py) and unguarded JAX Rodrigues
math (reference: src/reconstruction/bundle_adjustment/utils.py:21-44, whose
``rot_mat_from_vec`` divides by ``theta`` with no theta->0 guard and whose
``pose_mat_to_vec`` runs on host numpy).  Everything here is pure jnp, safe at
the theta->0 and theta->pi singularities, differentiable, and usable under
jit/vmap/shard_map on any backend.

Conventions:
  - Quaternions are ``wxyz`` (COLMAP order).  Helpers convert from scipy's
    ``xyzw`` where needed.
  - All functions operate on single elements; ``*_batch`` wrappers vmap them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-12


def skew(v: jax.Array) -> jax.Array:
    """Skew-symmetric cross-product matrix [v]_x such that [v]_x w = v x w."""
    z = jnp.zeros((), dtype=v.dtype)
    return jnp.array(
        [
            [z, -v[2], v[1]],
            [v[2], z, -v[0]],
            [-v[1], v[0], z],
        ]
    )


def rodrigues_to_matrix(rvec: jax.Array) -> jax.Array:
    """Rodrigues (axis-angle) vector -> 3x3 rotation matrix.

    R = I + A [r]_x + B [r]_x^2 with A = sin(t)/t, B = (1-cos(t))/t^2,
    Taylor-expanded near t=0 so the map (and its derivatives) are finite
    everywhere — unlike the reference's rot_mat_from_vec (utils.py:21-28)
    which produces NaN at exactly zero rotation.
    """
    dtype = rvec.dtype
    # sum(v*v), not dot: accelerators run f32 jnp.dot at reduced input
    # precision by default (TF32 on the H100), and this module's callers
    # include OUTPUT paths outside any default_matmul_precision context
    # (measured: a bf16 dot here put ~6e-3 rad of error on converged
    # pose-refiner results).
    theta2 = jnp.sum(rvec * rvec)
    small = theta2 < jnp.asarray(1e-8, dtype)
    # Guarded denominators: both branches of each where must be finite (and
    # have finite grads) or reverse-mode AD produces 0 * inf = NaN.
    theta2_safe = jnp.where(small, jnp.ones((), dtype), theta2)
    theta = jnp.sqrt(theta2_safe)
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2_safe)
    k = skew(rvec)
    kk = jnp.matmul(k, k, precision=jax.lax.Precision.HIGHEST)
    return jnp.eye(3, dtype=dtype) + a * k + b * kk


def matrix_to_quat(rmat: jax.Array) -> jax.Array:
    """Rotation matrix -> unit quaternion (wxyz), w >= 0.

    Branch-free Shepperd construction: build all four candidate quaternions and
    select the one seeded from the largest of (1+tr, 1+2R00-tr, ...), which is
    numerically stable over the whole rotation group (incl. theta ~ pi where
    the reference's trace-based pose_mat_to_vec loses the axis).
    """
    dtype = rmat.dtype
    m00, m01, m02 = rmat[0, 0], rmat[0, 1], rmat[0, 2]
    m10, m11, m12 = rmat[1, 0], rmat[1, 1], rmat[1, 2]
    m20, m21, m22 = rmat[2, 0], rmat[2, 1], rmat[2, 2]

    # 4 * [w^2, x^2, y^2, z^2] (before clamping).
    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22
    seeds = jnp.stack([tw, tx, ty, tz])

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, jnp.asarray(_EPS, dtype)))

    sw = safe_sqrt(tw)
    sx = safe_sqrt(tx)
    sy = safe_sqrt(ty)
    sz = safe_sqrt(tz)

    cand = jnp.stack(
        [
            jnp.stack([sw * sw, m21 - m12, m02 - m20, m10 - m01]) / (2.0 * sw),
            jnp.stack([m21 - m12, sx * sx, m01 + m10, m02 + m20]) / (2.0 * sx),
            jnp.stack([m02 - m20, m01 + m10, sy * sy, m12 + m21]) / (2.0 * sy),
            jnp.stack([m10 - m01, m02 + m20, m12 + m21, sz * sz]) / (2.0 * sz),
        ]
    )
    q = cand[jnp.argmax(seeds)]
    q = q / jnp.linalg.norm(q)
    return jnp.where(q[0] < 0, -q, q)


def quat_to_matrix(q: jax.Array) -> jax.Array:
    """Unit quaternion (wxyz) -> 3x3 rotation matrix."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return jnp.array(
        [
            [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
            [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
            [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
        ]
    )


def quat_to_rodrigues(q: jax.Array) -> jax.Array:
    """Unit quaternion (wxyz) -> Rodrigues vector, safe near identity."""
    dtype = q.dtype
    q = jnp.where(q[0] < 0, -q, q)  # w >= 0 => angle in [0, pi]
    w = q[0]
    v = q[1:]
    n2 = jnp.sum(v * v)  # not jnp.dot: reduced precision outside precision scopes
    small = n2 < jnp.asarray(1e-12, dtype)
    n = jnp.sqrt(jnp.where(small, jnp.ones((), dtype), n2))
    w_safe = jnp.where(small, w, jnp.ones((), dtype))  # w can be 0 at theta=pi
    angle = 2.0 * jnp.arctan2(n, w)
    # rvec = angle * v / n; near identity angle/n -> 2/w - 2 n^2/(3 w^3).
    scale = jnp.where(small, 2.0 / w_safe - 2.0 * n2 / (3.0 * w_safe**3), angle / n)
    return scale * v


def rodrigues_to_quat(rvec: jax.Array) -> jax.Array:
    """Rodrigues vector -> unit quaternion (wxyz), safe near zero."""
    dtype = rvec.dtype
    theta2 = jnp.sum(rvec * rvec)  # not jnp.dot: reduced precision (see above)
    small = theta2 < jnp.asarray(1e-8, dtype)
    theta = jnp.sqrt(jnp.where(small, jnp.ones((), dtype), theta2))
    half = 0.5 * theta
    # sin(t/2)/t, Taylor: 1/2 - t^2/48.
    s = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / theta)
    w = jnp.where(small, 1.0 - theta2 / 8.0, jnp.cos(half))
    return jnp.concatenate([w[None], s * rvec])


def matrix_to_rodrigues(rmat: jax.Array) -> jax.Array:
    """Rotation matrix -> Rodrigues vector (device-side, jit/vmap-safe).

    Replaces the reference's host-numpy ``pose_mat_to_vec``
    (utils.py:31-44); routed through the quaternion for stability at
    theta ~ 0 and theta ~ pi.
    """
    return quat_to_rodrigues(matrix_to_quat(rmat))


def quat_mul(a: jax.Array, b: jax.Array) -> jax.Array:
    """Hamilton product of two wxyz quaternions."""
    aw, ax, ay, az = a[0], a[1], a[2], a[3]
    bw, bx, by, bz = b[0], b[1], b[2], b[3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def quat_rotate(q: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate vector v by unit quaternion q (wxyz) without forming the matrix."""
    u = q[1:]
    w = q[0]
    t = 2.0 * jnp.cross(u, v)
    return v + w * t + jnp.cross(u, t)


def xyzw_to_wxyz(q: jax.Array) -> jax.Array:
    return jnp.concatenate([q[..., 3:4], q[..., 0:3]], axis=-1)


def wxyz_to_xyzw(q: jax.Array) -> jax.Array:
    return jnp.concatenate([q[..., 1:4], q[..., 0:1]], axis=-1)


# Batched (leading-axis) forms, used by the packed solvers.
rodrigues_to_matrix_batch = jax.vmap(rodrigues_to_matrix)
matrix_to_rodrigues_batch = jax.vmap(matrix_to_rodrigues)
quat_to_matrix_batch = jax.vmap(quat_to_matrix)
matrix_to_quat_batch = jax.vmap(matrix_to_quat)
rodrigues_to_quat_batch = jax.vmap(rodrigues_to_quat)
quat_to_rodrigues_batch = jax.vmap(quat_to_rodrigues)
