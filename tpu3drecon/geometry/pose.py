"""Functional rigid-pose algebra with tagged coordinate-system semantics.

Array-level re-design of the reference's ``CameraPose`` object algebra
(reference: src/dataset/camera_pose/camera_pose.py:49-140 and
constants.py:3-7): inverse, composition, LH("UNITY")<->RH("COLMAP")
coordinate-system conversion via conjugation with diag(1,-1,1), and
C2W<->W2C direction flips.  A pose here is the pair ``(rmat, tvec)``; the
object-level wrapper with metadata tags lives in
``tpu3drecon.dataset.camera_pose``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# Small 3x3/3-vector matmuls at explicit HIGHEST precision: these run on
# OUTPUT/eval paths outside any default_matmul_precision scope, where an
# accelerator's reduced-precision f32 matmul default (bf16 passes, or TF32
# on the H100) silently costs ~1e-3 of rotation accuracy (measured on the
# pose-refiner output path).
_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

# Conjugation matrix flipping the Y axis (LH Unity <-> RH COLMAP).
# Reference: src/dataset/camera_pose/constants.py:3-7.
# NOTE: built lazily — a module-level jnp.array would initialize the XLA
# backend at import time, which breaks jax.distributed.initialize (it must
# run before ANY backend init; see experiments/distributed_smoke.py).
import numpy as _np

_CONVERSION_NP = _np.array(
    [
        [1.0, 0.0, 0.0],
        [0.0, -1.0, 0.0],
        [0.0, 0.0, 1.0],
    ]
)


def __getattr__(name):
    if name == "CONVERSION_MATRIX":
        return jnp.asarray(_CONVERSION_NP)
    raise AttributeError(name)


def pose_inverse(rmat: jax.Array, tvec: jax.Array):
    """(R, t) -> (R^T, -R^T t): flips C2W <-> W2C.

    Same math as CameraPose.inverse (camera_pose.py:64-71).
    """
    rinv = rmat.T
    return rinv, -_mm(rinv, tvec)


def pose_compose(rmat_a, tvec_a, rmat_b, tvec_b):
    """Compose transforms: (a . b)(x) = a(b(x))."""
    return _mm(rmat_a, rmat_b), _mm(rmat_a, tvec_b) + tvec_a


def pose_convert_coordinate_system(rmat: jax.Array, tvec: jax.Array):
    """Conjugate a pose with diag(1,-1,1) (LH <-> RH, involutive).

    Same math as CameraPose.in_coordinate_system (camera_pose.py:49-62):
    R' = C R C, t' = C t.
    """
    conv = jnp.asarray(_CONVERSION_NP, rmat.dtype)
    return _mm(_mm(conv, rmat), conv), _mm(conv, tvec)


def pose_apply(rmat: jax.Array, tvec: jax.Array, xyz: jax.Array) -> jax.Array:
    """Apply pose to 3D point(s): R x + t (xyz may have leading batch dims)."""
    return _mm(xyz, rmat.T) + tvec


def pose_to_matrix_3x4(rmat: jax.Array, tvec: jax.Array) -> jax.Array:
    """[R | t] (reference rotation_translation_matrix, camera_pose.py:118-120)."""
    return jnp.concatenate([rmat, tvec[:, None]], axis=1)


def pose_to_matrix_4x4(rmat: jax.Array, tvec: jax.Array) -> jax.Array:
    """Homogeneous 4x4 transform (transformation_translation_matrix)."""
    bottom = jnp.array([[0.0, 0.0, 0.0, 1.0]], dtype=rmat.dtype)
    return jnp.concatenate([pose_to_matrix_3x4(rmat, tvec), bottom], axis=0)


def camera_center(rmat_w2c: jax.Array, tvec_w2c: jax.Array) -> jax.Array:
    """World-frame camera center of a W2C pose: -R^T t.

    Counterpart of CameraPose.position (camera_pose.py:109-113).
    """
    return -_mm(rmat_w2c.T, tvec_w2c)


def rotation_geodesic_angle(rmat_a: jax.Array, rmat_b: jax.Array) -> jax.Array:
    """Geodesic angle (radians) between two rotations, safe at 0 and pi.

    Robust counterpart of compute_rotation_error_in_rad
    (camera_pose.py:301-313).
    """
    rel = _mm(rmat_a.T, rmat_b)
    cos = (jnp.trace(rel) - 1.0) * 0.5
    return jnp.arccos(jnp.clip(cos, -1.0, 1.0))


def rotation_identity_error(rmat_a: jax.Array, rmat_b: jax.Array) -> jax.Array:
    """Frobenius distance of the relative rotation from identity.

    Counterpart of compute_rotation_error (camera_pose.py:285-299).
    """
    rel = _mm(rmat_a.T, rmat_b)
    return jnp.linalg.norm(rel - jnp.eye(3, dtype=rmat_a.dtype))


def position_error(center_a: jax.Array, center_b: jax.Array) -> jax.Array:
    """Euclidean distance between camera centers (camera_pose.py:281-283)."""
    return jnp.linalg.norm(center_a - center_b)


# Batched forms over a leading camera axis.
pose_inverse_batch = jax.vmap(pose_inverse)
pose_convert_coordinate_system_batch = jax.vmap(pose_convert_coordinate_system)
pose_to_matrix_3x4_batch = jax.vmap(pose_to_matrix_3x4)
camera_center_batch = jax.vmap(camera_center)
rotation_geodesic_angle_batch = jax.vmap(rotation_geodesic_angle)
