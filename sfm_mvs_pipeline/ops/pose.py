"""Pose algebra: angle-axis <-> rotation matrices, [R|t] composition.

Array replacement for the reference's pose plumbing:
  * cv::Rodrigues accessors          (ref: src/photogrammetrie/common/CameraShot.cpp:92-108)
  * ceres 6-vector angle-axis poses  (ref: src/photogrammetrie/util/CeresUtils.h:90-148)

A pose is a 6-vector `[rvec(3), tvec(3)]` mapping WORLD -> CAMERA:
    x_cam = R(rvec) @ x_world + t
matching both the OpenCV [R|t] convention and the Ceres parameter block the
reference optimizes. All functions are batched over leading axes via vmap
and are safe under jit (no data-dependent control flow).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-12


def aa_to_rotmat(rvec: jax.Array) -> jax.Array:
    """Angle-axis (3,) -> rotation matrix (3, 3). Rodrigues' formula.

    Taylor-safe at theta ~ 0 (uses sinc-style series switch).
    """
    rvec = jnp.asarray(rvec)
    theta2 = jnp.sum(rvec * rvec, axis=-1)
    small = theta2 < 1e-8
    # Evaluate the exact branch at a SAFE theta when small: jnp.where does
    # not stop the unused branch from being computed, and (1-cos)/theta2 at
    # theta2 == 0 is inf — fine in forward mode (masked) but NaN through
    # reverse-mode AD (jacrev), which the BA build now uses. The Taylor
    # branches keep the true theta2 so gradients near zero stay exact.
    theta2_safe = jnp.where(small, jnp.ones_like(theta2), theta2)
    theta = jnp.sqrt(theta2_safe)

    # sin(t)/t and (1-cos(t))/t^2 with series fallbacks
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(
        small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2_safe
    )

    kx, ky, kz = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    zero = jnp.zeros_like(kx)
    K = jnp.stack(
        [
            jnp.stack([zero, -kz, ky], axis=-1),
            jnp.stack([kz, zero, -kx], axis=-1),
            jnp.stack([-ky, kx, zero], axis=-1),
        ],
        axis=-2,
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=rvec.dtype), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def aa_to_rotmat_np(rvec) -> "np.ndarray":
    """Pure-numpy Rodrigues for HOST-side consumers (PLY writers, stats,
    geometry prechecks): a device round trip per eager op costs far more
    than the math on a handful of cameras. Accepts (..., 3); returns
    (..., 3, 3)."""
    import numpy as np

    rvec = np.asarray(rvec, np.float64)
    theta2 = np.sum(rvec * rvec, axis=-1)
    small = theta2 < 1e-12
    theta = np.sqrt(np.where(small, 1.0, theta2))
    a = np.where(small, 1.0 - theta2 / 6.0, np.sin(theta) / theta)
    b = np.where(
        small, 0.5 - theta2 / 24.0,
        (1.0 - np.cos(theta)) / np.where(small, 1.0, theta2),
    )
    kx, ky, kz = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    zero = np.zeros_like(kx)
    K = np.stack(
        [
            np.stack([zero, -kz, ky], axis=-1),
            np.stack([kz, zero, -kx], axis=-1),
            np.stack([-ky, kx, zero], axis=-1),
        ],
        axis=-2,
    )
    eye = np.broadcast_to(np.eye(3), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def rotmat_to_aa(R: jax.Array) -> jax.Array:
    """Rotation matrix (3, 3) -> angle-axis (3,). Inverse Rodrigues.

    Branchless (jnp.where) handling of the theta ~ 0 and theta ~ pi cases so
    it stays jit/vmap-friendly.
    """
    R = jnp.asarray(R)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_t)

    # Skew part: (R - R^T)/2 = sin(theta) * K
    w = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin_t = jnp.sin(theta)

    # Generic case: axis = w / (2 sin t), rvec = theta * axis
    generic = w * (theta / (2.0 * sin_t + _EPS))[..., None]
    # Small angle: rvec ~ w / 2 (first order)
    small = w * 0.5

    # Near pi: sin t -> 0 but w -> 0 too; recover axis from diagonal of
    # R = 2 aa^T - I  =>  a_i = sqrt((R_ii + 1)/2), signs from off-diagonals.
    axis2 = jnp.clip(
        (jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1) + 1.0) * 0.5,
        0.0,
        None,
    )
    axis_abs = jnp.sqrt(axis2)
    # pick the largest component as reference for sign resolution
    # signs: a_x*a_y = R_01/2, a_x*a_z = R_02/2, a_y*a_z = R_12/2
    sx = jnp.where(
        axis_abs[..., 0] >= jnp.maximum(axis_abs[..., 1], axis_abs[..., 2]),
        1.0,
        jnp.where(
            axis_abs[..., 1] >= axis_abs[..., 2],
            jnp.sign(R[..., 0, 1] + _EPS),
            jnp.sign(R[..., 0, 2] + _EPS),
        ),
    )
    sy = jnp.where(
        axis_abs[..., 0] >= jnp.maximum(axis_abs[..., 1], axis_abs[..., 2]),
        jnp.sign(R[..., 0, 1] + _EPS),
        jnp.where(
            axis_abs[..., 1] >= axis_abs[..., 2],
            1.0,
            jnp.sign(R[..., 1, 2] + _EPS) * jnp.sign(R[..., 0, 2] + _EPS) * sx,
        ),
    )
    sz = jnp.where(
        axis_abs[..., 0] >= jnp.maximum(axis_abs[..., 1], axis_abs[..., 2]),
        jnp.sign(R[..., 0, 2] + _EPS),
        jnp.where(
            axis_abs[..., 1] >= axis_abs[..., 2],
            jnp.sign(R[..., 1, 2] + _EPS),
            1.0,
        ),
    )
    axis_pi = axis_abs * jnp.stack([sx, sy, sz], axis=-1)
    axis_pi = axis_pi / (jnp.linalg.norm(axis_pi, axis=-1, keepdims=True) + _EPS)
    near_pi_rvec = axis_pi * theta[..., None]

    is_small = (theta < 1e-5)[..., None]
    is_near_pi = (jnp.abs(theta - jnp.pi) < 1e-3)[..., None]
    return jnp.where(is_small, small, jnp.where(is_near_pi, near_pi_rvec, generic))


def pose_to_mat34(pose: jax.Array) -> jax.Array:
    """Pose 6-vector -> 3x4 [R|t] matrix."""
    R = aa_to_rotmat(pose[..., :3])
    return jnp.concatenate([R, pose[..., 3:, None]], axis=-1)


def mat34_to_pose(P: jax.Array) -> jax.Array:
    """3x4 [R|t] -> pose 6-vector."""
    return jnp.concatenate([rotmat_to_aa(P[..., :3, :3]), P[..., :3, 3]], axis=-1)


def camera_center(pose: jax.Array) -> jax.Array:
    """Camera center in world coords: C = -R^T t.

    (ref: CameraShot::getCenter, src/photogrammetrie/common/CameraShot.cpp:104-108)
    """
    R = aa_to_rotmat(pose[..., :3])
    t = pose[..., 3:]
    return -jnp.einsum("...ji,...j->...i", R, t)


def transform_points(pose: jax.Array, pts: jax.Array) -> jax.Array:
    """Apply world->camera transform to points.

    pose: (..., 6), pts: (..., N, 3) or (..., 3) -> same shape as pts.
    """
    R = aa_to_rotmat(pose[..., :3])
    t = pose[..., 3:]
    if pts.ndim == pose.ndim:  # (..., 3) single point per pose
        return jnp.einsum("...ij,...j->...i", R, pts) + t
    return jnp.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def relative_pose(pose_a: jax.Array, pose_b: jax.Array) -> jax.Array:
    """Pose of camera b relative to camera a: x_b = R_rel x_a + t_rel.

    If x_a = R_a X + t_a and x_b = R_b X + t_b then
    R_rel = R_b R_a^T, t_rel = t_b - R_rel t_a.
    """
    Ra = aa_to_rotmat(pose_a[..., :3])
    Rb = aa_to_rotmat(pose_b[..., :3])
    R_rel = Rb @ jnp.swapaxes(Ra, -1, -2)
    t_rel = pose_b[..., 3:] - jnp.einsum("...ij,...j->...i", R_rel, pose_a[..., 3:])
    return jnp.concatenate([rotmat_to_aa(R_rel), t_rel], axis=-1)


def compose_pose(pose_outer: jax.Array, pose_inner: jax.Array) -> jax.Array:
    """Compose: result(x) = outer(inner(x))."""
    Ro = aa_to_rotmat(pose_outer[..., :3])
    Ri = aa_to_rotmat(pose_inner[..., :3])
    R = Ro @ Ri
    t = jnp.einsum("...ij,...j->...i", Ro, pose_inner[..., 3:]) + pose_outer[..., 3:]
    return jnp.concatenate([rotmat_to_aa(R), t], axis=-1)


def invert_pose(pose: jax.Array) -> jax.Array:
    """Inverse transform: camera->world."""
    R = aa_to_rotmat(pose[..., :3])
    Rt = jnp.swapaxes(R, -1, -2)
    t = -jnp.einsum("...ij,...j->...i", Rt, pose[..., 3:])
    return jnp.concatenate([rotmat_to_aa(Rt), t], axis=-1)


def identity_pose(dtype=jnp.float32) -> jax.Array:
    return jnp.zeros((6,), dtype=dtype)
