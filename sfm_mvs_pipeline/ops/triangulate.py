"""Batched two-view triangulation + reprojection filtering.

Batched replacement for the reference's per-pair triangulation
(cv::triangulatePoints DLT on undistorted normalized coords + reprojection
filter; ref: src/photogrammetrie/sfm/SfM.cpp:383-451).

Everything is batched over N points with static shapes; invalid points are
masked, never dropped, so the op composes with jit/vmap/shard_map.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sfm_mvs_pipeline.models.cameras import project_points, undistort_points
from sfm_mvs_pipeline.ops.pose import pose_to_mat34


def triangulate_dlt(
    P1: jax.Array, P2: jax.Array, xy1: jax.Array, xy2: jax.Array
) -> jax.Array:
    """DLT triangulation of N points from two views.

    P1, P2: (3, 4) projection matrices (for normalized coords these are the
    plain [R|t] poses, as in the reference which triangulates after
    cv::undistortPoints; ref: src/photogrammetrie/sfm/SfM.cpp:410-416).
    xy1, xy2: (N, 2) normalized image coords.

    Returns (N, 3) euclidean points. Solves the 4x4 DLT system per point via
    the eigenvector of A^T A with the smallest eigenvalue — a closed-form
    batched eigendecomposition on symmetric 4x4s, which XLA vectorizes well.
    """
    # Build A (N, 4, 4): rows [x*p3 - p1, y*p3 - p2] for each view
    def rows(P, xy):
        p1, p2, p3 = P[0], P[1], P[2]
        r1 = xy[:, 0:1] * p3[None, :] - p1[None, :]
        r2 = xy[:, 1:2] * p3[None, :] - p2[None, :]
        return r1, r2

    a1, a2 = rows(P1, xy1)
    a3, a4 = rows(P2, xy2)
    A = jnp.stack([a1, a2, a3, a4], axis=1)  # (N, 4, 4)

    AtA = jnp.einsum("nij,nik->njk", A, A)  # (N, 4, 4) symmetric PSD
    # Smallest eigenvector via eigh (batched); jax eigh handles (N,4,4) fine.
    _, vecs = jnp.linalg.eigh(AtA)
    X = vecs[..., 0]  # eigenvector for smallest eigenvalue
    w = X[..., 3]
    w_safe = jnp.where(jnp.abs(w) < 1e-12, jnp.where(w < 0, -1e-12, 1e-12), w)
    return X[..., :3] / w_safe[..., None]


def triangulate_pair(
    pose1: jax.Array,
    pose2: jax.Array,
    intr1: jax.Array,
    intr2: jax.Array,
    uv1: jax.Array,
    uv2: jax.Array,
    valid: jax.Array | None = None,
    max_reprojection_error: float | jax.Array = 10.0,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Full reference-semantics pair triangulation.

    Steps (mirroring src/photogrammetrie/sfm/SfM.cpp:383-451):
      1. undistort pixel matches to normalized coords
      2. DLT triangulation against the two [R|t] poses
      3. reproject into both views (with distortion) and keep points whose
         reprojection error is <= max_reprojection_error in BOTH views
         (ref default 10 px; src/cli/PhotogrammetrieCli.cpp usage `-Preprojection-error-threshold`)

    Returns (points3d (N,3), keep_mask (N,) bool, errors (N,2)).
    """
    xy1 = undistort_points(intr1, uv1)
    xy2 = undistort_points(intr2, uv2)
    P1 = pose_to_mat34(pose1)
    P2 = pose_to_mat34(pose2)
    pts3d = triangulate_dlt(P1, P2, xy1, xy2)

    uv1_hat, z1 = project_points(pose1, intr1, pts3d)
    uv2_hat, z2 = project_points(pose2, intr2, pts3d)
    e1 = jnp.linalg.norm(uv1_hat - uv1, axis=-1)
    e2 = jnp.linalg.norm(uv2_hat - uv2, axis=-1)

    keep = (e1 <= max_reprojection_error) & (e2 <= max_reprojection_error)
    # cheirality: in front of both cameras (recoverPose in the reference
    # guarantees this for inliers; we enforce it explicitly)
    keep = keep & (z1 > 0) & (z2 > 0)
    keep = keep & jnp.all(jnp.isfinite(pts3d), axis=-1)
    if valid is not None:
        keep = keep & valid
    return pts3d, keep, jnp.stack([e1, e2], axis=-1)
