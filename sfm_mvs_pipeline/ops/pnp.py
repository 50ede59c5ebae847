"""Batched RANSAC PnP (3D->2D pose) + Gauss-Newton polish.

Replaces cv::solvePnPRansac (ref: src/photogrammetrie/sfm/SfM.cpp:453-489;
100 iterations, confidence 0.99, threshold via the reference sign
convention) used to register each new view from its 3D-2D correspondences.

Hypotheses use the 6-point DLT: solve for the 3x4 projection matrix from 6
sampled correspondences on undistorted normalized coords, then project the
3x3 block onto SO(3) via SVD. Scoring = full-distortion reprojection error
in pixels (what cv scores). The winner is polished with a few Gauss-Newton
steps on the inlier set (cv's iterative refinement equivalent) — autodiff
Jacobians via jax.jacfwd on the 6-dof residual.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from sfm_mvs_pipeline.models.cameras import project_points, undistort_points
from sfm_mvs_pipeline.ops.pose import rotmat_to_aa
from sfm_mvs_pipeline.ops.ransac import sample_valid_indices, select_best


def _dlt_pnp(X: jax.Array, xy: jax.Array) -> jax.Array:
    """6+ point DLT for P = [R|t] from world points X (M,3) and normalized
    image coords xy (M,2). Returns pose 6-vector (angle-axis, t)."""
    x, y = xy[:, 0], xy[:, 1]
    Xh = jnp.concatenate([X, jnp.ones_like(X[:, :1])], axis=1)  # (M, 4)
    zero = jnp.zeros_like(Xh)
    r1 = jnp.concatenate([Xh, zero, -x[:, None] * Xh], axis=1)  # (M, 12)
    r2 = jnp.concatenate([zero, Xh, -y[:, None] * Xh], axis=1)
    A = jnp.concatenate([r1, r2], axis=0)  # (2M, 12)
    _, vecs = jnp.linalg.eigh(A.T @ A)
    p = vecs[:, 0].reshape(3, 4)
    # fix sign: points should be in front (positive depth) for the majority
    depths = Xh @ p[2]
    p = p * jnp.sign(jnp.sum(jnp.sign(depths)) + 0.5)
    # project rotation part onto SO(3), rescale t by the mean singular value
    U, s, Vt = jnp.linalg.svd(p[:, :3])
    det = jnp.linalg.det(U @ Vt)
    D = jnp.diag(jnp.array([1.0, 1.0, 0.0], p.dtype)) + jnp.diag(
        jnp.array([0.0, 0.0, 1.0], p.dtype)
    ) * det
    R = U @ D @ Vt
    scale = jnp.sum(s) / 3.0
    t = p[:, 3] / jnp.maximum(scale, 1e-12) * det
    return jnp.concatenate([rotmat_to_aa(R), t])


def _planar_pnp(X: jax.Array, xy: jax.Array) -> jax.Array:
    """4-point plane-homography pose (IPPE-style): both sign branches.

    The 6-point DLT is DEGENERATE when the 3D points are coplanar (the
    12-dof projective system loses rank) — exactly the quasi-planar maps
    of the low-texture boundary regime, where cv2's EPnP (with its planar
    special case) keeps registering views while the DLT emits garbage.
    This solver is exact for planar samples: express the sample in an
    in-plane frame, fit the plane→image homography H ~ [R·b1 R·b2 R·c+t],
    read the pose off its columns, and orthonormalize. Returns (2, 6)
    poses — the homography's sign ambiguity gives two candidates; RANSAC
    scoring (behind-camera → inf residual) kills the wrong one.

    X (M,3) world points, xy (M,2) normalized image coords.
    """
    from sfm_mvs_pipeline.ops.homography import _dlt_h

    c = jnp.mean(X, axis=0)
    A = X - c
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    b1, b2 = Vt[0], Vt[1]
    n = jnp.cross(b1, b2)  # right-handed: (R b1)x(R b2) = R n
    En = jnp.stack([b1, b2, n], axis=1)  # (3,3) plane frame
    uv = A @ En[:, :2]  # in-plane coordinates
    H = _dlt_h(uv, xy)
    s = 2.0 / jnp.maximum(
        jnp.linalg.norm(H[:, 0]) + jnp.linalg.norm(H[:, 1]), 1e-12
    )

    def pose_from(Hs):
        r1, r2 = Hs[:, 0], Hs[:, 1]
        M = jnp.stack([r1, r2, jnp.cross(r1, r2)], axis=1)
        U, _, Vt2 = jnp.linalg.svd(M)
        det = jnp.linalg.det(U @ Vt2)
        D = jnp.diag(jnp.array([1.0, 1.0, 0.0], Hs.dtype)) + jnp.diag(
            jnp.array([0.0, 0.0, 1.0], Hs.dtype)
        ) * det
        R0 = U @ D @ Vt2  # ≈ R·[b1 b2 n]
        R = R0 @ En.T
        t = Hs[:, 2] - R @ c
        return jnp.concatenate([rotmat_to_aa(R), t])

    return jnp.stack([pose_from(s * H), pose_from(-s * H)])


def _reproj_residuals_px(pose, intr, X, uv):
    uv_hat, z = project_points(pose, intr, X)
    r = jnp.linalg.norm(uv_hat - uv, axis=-1)
    # behind-camera points are not inliers
    return jnp.where(z > 0, r, jnp.inf)


@functools.partial(jax.jit, static_argnames=("k_hyp", "gn_iters"))
def solve_pnp_ransac(
    key: jax.Array,
    X: jax.Array,  # (N, 3) world points
    uv: jax.Array,  # (N, 2) pixel observations
    intr: jax.Array,  # (7,) intrinsics
    valid: jax.Array,  # (N,) bool
    thresh_px: float | jax.Array,
    k_hyp: int = 256,
    gn_iters: int = 10,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Batched RANSAC PnP. Returns (pose6, inlier_mask, inlier_ratio).

    inlier_ratio is inliers / valid-count — the quantity the reference
    compares against `-Ppose-inlier-ratio-threshold` (SfM.cpp:481-484).
    """
    xy = undistort_points(intr, uv)
    k_dlt = k_hyp // 2
    k_pl = (k_hyp - k_dlt) // 2  # planar samples emit 2 poses each
    key_d, key_p = jax.random.split(key)
    idx = sample_valid_indices(key_d, valid, k_dlt, 6)
    poses_dlt = jax.vmap(lambda s: _dlt_pnp(X[s], xy[s]))(idx)  # (K/2, 6)
    # planar hypothesis family: exact for coplanar maps where the DLT
    # is degenerate (see _planar_pnp)
    idx4 = sample_valid_indices(key_p, valid, k_pl, 4)
    poses_pl = jax.vmap(lambda s: _planar_pnp(X[s], xy[s]))(idx4)
    poses = jnp.concatenate([poses_dlt, poses_pl.reshape(-1, 6)])
    res = jax.vmap(lambda p: _reproj_residuals_px(p, intr, X, uv))(poses)
    pose, mask, count = select_best(poses, res, valid, thresh_px)

    # Gauss-Newton polish on inliers (6-dof; fixed iteration count)
    def residual_vec(p, w):
        uv_hat, _ = project_points(p, intr, X)
        return ((uv_hat - uv) * w[:, None]).reshape(-1)

    def gn_step(p, _):
        w = mask.astype(X.dtype)
        J = jax.jacfwd(residual_vec)(p, w)  # (2N, 6)
        r = residual_vec(p, w)
        H = J.T @ J + 1e-6 * jnp.eye(6, dtype=X.dtype)
        g = J.T @ r
        dp = jnp.linalg.solve(H, g)
        p_new = p - dp
        # accept only if cost decreases
        better = jnp.sum(residual_vec(p_new, w) ** 2) < jnp.sum(r**2)
        return jnp.where(better, p_new, p), None

    pose, _ = jax.lax.scan(gn_step, pose, None, length=gn_iters)

    res_final = _reproj_residuals_px(pose, intr, X, uv)
    mask = (res_final <= thresh_px) & valid & jnp.isfinite(res_final)
    ratio = jnp.sum(mask) / jnp.maximum(jnp.sum(valid), 1)
    return pose, mask, ratio
