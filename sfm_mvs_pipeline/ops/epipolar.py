"""Batched essential-matrix estimation + relative pose recovery.

Replaces cv::findEssentialMat(RANSAC) + cv::recoverPose
(ref: src/photogrammetrie/sfm/SfM.cpp:491-540) for baseline/new-pair pose
recovery.

Algorithm: batched 8-point hypotheses on undistorted normalized coords with
essential-constraint projection (singular values -> (1,1,0)), Sampson-error
scoring, then the classic 4-way (R, t) decomposition disambiguated by a
cheirality vote over all inlier correspondences. Thresholds given in pixels
are divided by the focal length to act on normalized coords (matching cv's
internal focal scaling).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from sfm_mvs_pipeline.ops.ransac import sample_valid_indices, select_best
from sfm_mvs_pipeline.ops.triangulate import triangulate_dlt
from sfm_mvs_pipeline.ops.pose import rotmat_to_aa


def _eight_point(x1: jax.Array, x2: jax.Array) -> jax.Array:
    """8-point algorithm on normalized coords. x: (M, 2). Returns E (3,3)."""
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    one = jnp.ones_like(u1)
    # epipolar constraint x2^T E x1 = 0
    A = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], axis=1
    )  # (M, 9)
    AtA = A.T @ A
    _, vecs = jnp.linalg.eigh(AtA)
    E = vecs[:, 0].reshape(3, 3)
    # project onto essential manifold: singular values (1, 1, 0)
    U, s, Vt = jnp.linalg.svd(E)
    E = U @ jnp.diag(jnp.array([1.0, 1.0, 0.0], dtype=E.dtype)) @ Vt
    return E


def sampson_error(E: jax.Array, x1: jax.Array, x2: jax.Array) -> jax.Array:
    """First-order geometric (Sampson) distance in normalized coords. (N,)"""
    x1h = jnp.concatenate([x1, jnp.ones_like(x1[..., :1])], axis=-1)
    x2h = jnp.concatenate([x2, jnp.ones_like(x2[..., :1])], axis=-1)
    Ex1 = x1h @ E.T  # (N, 3)
    Etx2 = x2h @ E  # (N, 3)
    num = jnp.sum(x2h * Ex1, axis=-1)
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return jnp.abs(num) / jnp.sqrt(den + 1e-18)


def decompose_essential(E: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """E -> (R1, R2, t). The four pose candidates are (R1,t),(R1,-t),(R2,t),(R2,-t)."""
    U, _, Vt = jnp.linalg.svd(E)
    # enforce proper rotations
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    return R1, R2, t


@functools.partial(jax.jit, static_argnames=("k_hyp",))
def find_essential_ransac(
    key: jax.Array,
    xy1: jax.Array,
    xy2: jax.Array,
    valid: jax.Array,
    thresh_norm: float | jax.Array,
    k_hyp: int = 512,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """RANSAC essential matrix on normalized coords.

    Returns (E, inlier_mask, inlier_count). thresh_norm is the Sampson
    threshold in NORMALIZED units (pixel threshold / focal length).
    """
    idx = sample_valid_indices(key, valid, k_hyp, 8)
    Es = jax.vmap(lambda s: _eight_point(xy1[s], xy2[s]))(idx)
    res = jax.vmap(lambda E: sampson_error(E, xy1, xy2))(Es)
    E, mask, count = select_best(Es, res, valid, thresh_norm)

    # polish: re-estimate from all inliers (weighted 8-point), keep if better
    w = mask.astype(xy1.dtype)[:, None]
    u1, v1 = xy1[:, 0], xy1[:, 1]
    u2, v2 = xy2[:, 0], xy2[:, 1]
    one = jnp.ones_like(u1)
    A = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], axis=1
    ) * w
    _, vecs = jnp.linalg.eigh(A.T @ A)
    E2 = vecs[:, 0].reshape(3, 3)
    U, s, Vt = jnp.linalg.svd(E2)
    E2 = U @ jnp.diag(jnp.array([1.0, 1.0, 0.0], dtype=E2.dtype)) @ Vt
    res2 = sampson_error(E2, xy1, xy2)
    mask2 = (res2 <= thresh_norm) & valid & jnp.isfinite(res2)
    count2 = jnp.sum(mask2)
    better = count2 >= count
    return (
        jnp.where(better, E2, E),
        jnp.where(better, mask2, mask),
        jnp.maximum(count2, count),
    )


def _candidate_stats(
    Rs: jax.Array, ts: jax.Array, xy1: jax.Array, xy2: jax.Array, mask: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Cheirality statistics of K pose candidates.

    Rs (K,3,3), ts (K,3). Returns (counts (K,) of positive-depth masked
    points, goods (K,N) per-point cheirality)."""
    dt = xy1.dtype
    eye34 = jnp.concatenate([jnp.eye(3, dtype=dt), jnp.zeros((3, 1), dt)], axis=1)

    def cheirality(R, tv):
        P2 = jnp.concatenate([R, tv[:, None]], axis=1)
        X = triangulate_dlt(eye34, P2, xy1, xy2)
        z1 = X[:, 2]
        z2 = (X @ R.T + tv)[:, 2]
        # clamp depth test to a generous far plane like cv (50 / |t|=1 scale)
        good = (z1 > 0) & (z2 > 0) & (z1 < 50.0) & (z2 < 50.0)
        return jnp.sum(good & mask), good

    return jax.vmap(cheirality)(Rs, ts)


def _cheirality_vote(
    Rs: jax.Array, ts: jax.Array, xy1: jax.Array, xy2: jax.Array, mask: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Pick the (R, t) candidate with the most positive-depth triangulations.

    Rs (K,3,3), ts (K,3). Returns (pose6 [rvec|t], mask & good-under-winner).
    """
    counts, goods = _candidate_stats(Rs, ts, xy1, xy2, mask)
    best = jnp.argmax(counts)
    pose = jnp.concatenate([rotmat_to_aa(Rs[best]), ts[best]])
    return pose, mask & goods[best]


@jax.jit
def recover_pose(
    E: jax.Array, xy1: jax.Array, xy2: jax.Array, mask: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Disambiguate the 4 (R, t) candidates by cheirality voting.

    Mirrors cv::recoverPose (ref call: SfM.cpp:528): triangulate the masked
    correspondences under each candidate, count points with positive depth in
    both views, pick the winner. Returns (pose6 [rvec|t] with |t| = 1,
    updated mask = input mask AND positive-depth under the winner).
    """
    R1, R2, t = decompose_essential(E)
    Rs = jnp.stack([R1, R1, R2, R2])
    ts = jnp.stack([t, -t, t, -t])
    return _cheirality_vote(Rs, ts, xy1, xy2, mask)


def decompose_homography(
    H: jax.Array,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Faugeras-Lustman decomposition of a CALIBRATED homography.

    H maps normalized coords x2 ~ H x1 between two views of a plane:
    H ~ d·R + t·nᵀ. Returns the 8 motion hypotheses (Rs (8,3,3), ts (8,3)
    unit-norm, ns (8,3) plane normals in camera-1 frame) — 4 sign
    combinations for each of the d' = ±d2 cases. The caller disambiguates
    by cheirality (recover_pose_from_homography).

    This is the planar-scene complement to the 8-point essential path: for
    coplanar correspondences the epipolar linear system is degenerate (any
    E of the form [v]ₓH fits exactly), while the homography is exactly
    determined. cv's 5-point solver (the reference's
    cv::findEssentialMat, SfM.cpp:525) is immune to this degeneracy; this
    decomposition restores that robustness on the device without a 10th-degree
    polynomial solver.
    """
    dt = H.dtype
    U, sv, Vt = jnp.linalg.svd(H)
    V = Vt.T
    s = jnp.linalg.det(U) * jnp.linalg.det(V)
    d2 = jnp.maximum(sv[1], 1e-12)
    d1 = sv[0] / d2
    d3 = sv[2] / d2
    den = jnp.maximum(d1 * d1 - d3 * d3, 1e-12)
    aux1 = jnp.sqrt(jnp.clip((d1 * d1 - 1.0) / den, 0.0, None))
    aux3 = jnp.sqrt(jnp.clip((1.0 - d3 * d3) / den, 0.0, None))
    sgn1 = jnp.array([1.0, 1.0, -1.0, -1.0], dt)
    sgn3 = jnp.array([1.0, -1.0, 1.0, -1.0], dt)
    x1 = aux1 * sgn1  # (4,)
    x3 = aux3 * sgn3
    prod = jnp.sqrt(jnp.clip((d1 * d1 - 1.0) * (1.0 - d3 * d3), 0.0, None))
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)

    # case d' = +d2: R' is a rotation about the y-axis of the SVD frame
    ct = ((1.0 + d1 * d3) / jnp.maximum(d1 + d3, 1e-12)) * o
    st = (prod / jnp.maximum(d1 + d3, 1e-12)) * sgn1 * sgn3
    Rp_a = jnp.stack(
        [
            jnp.stack([ct, z, -st], -1),
            jnp.stack([z, o, z], -1),
            jnp.stack([st, z, ct], -1),
        ],
        -2,
    )  # (4, 3, 3)
    tp_a = (d1 - d3) * jnp.stack([x1, z, -x3], -1)  # (4, 3)

    # case d' = -d2: R' is a rotation composed with the y-reflection
    # (det(R'_b) = cφ² + sφ² = 1 — still a proper rotation)
    cp = ((d1 * d3 - 1.0) / jnp.maximum(d1 - d3, 1e-12)) * o
    sp = (prod / jnp.maximum(d1 - d3, 1e-12)) * sgn1 * sgn3
    Rp_b = jnp.stack(
        [
            jnp.stack([cp, z, sp], -1),
            jnp.stack([z, -o, z], -1),
            jnp.stack([sp, z, -cp], -1),
        ],
        -2,
    )
    tp_b = (d1 + d3) * jnp.stack([x1, z, x3], -1)

    Rp = jnp.concatenate([Rp_a, Rp_b], 0)  # (8, 3, 3)
    tp = jnp.concatenate([tp_a, tp_b], 0)
    n_p = jnp.stack([x1, z, x3], -1)
    n_p = jnp.concatenate([n_p, n_p], 0)  # (8, 3)

    Rs = s * jnp.einsum("ij,kjl,lm->kim", U, Rp, Vt)
    ts = tp @ U.T  # (8, 3)
    ts = ts / jnp.maximum(jnp.linalg.norm(ts, axis=-1, keepdims=True), 1e-12)
    ns = n_p @ V.T
    return Rs, ts, ns


@jax.jit
def two_view_model_scores(
    E: jax.Array,
    H: jax.Array,
    xy1: jax.Array,
    xy2: jax.Array,
    valid: jax.Array,
    sigma: float | jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """ORB-SLAM-style model-selection scores (S_E, S_H).

    A degenerate 8-point E on a planar scene reconstructs a WRONG but
    photoconsistent two-view geometry — triangulation support cannot tell
    it from the truth (both fit every correspondence). The discriminator
    that works is the relative quality of the two image-to-image models
    themselves (Mur-Artal et al., ORB-SLAM, IEEE T-RO 2015 §IV.A):

      S_E: truncated chi-square score of point-to-epiline distances, both
           directions, per-direction inlier threshold 3.841σ², score cap
           5.991σ² (so the two scores are comparable).
      S_H: truncated score of symmetric transfer errors under H (and
           H⁻¹), threshold = cap = 5.991σ².

    The caller picks H when S_H / (S_H + S_E) > 0.45 — planar or
    low-parallax scenes score near 0.5 (both models explain everything,
    so E earned no advantage), while genuine parallax drops H support.
    sigma is the measurement noise scale in the coordinate units of
    xy1/xy2 (normalized coords here: pixel sigma / focal).
    """
    s2 = sigma * sigma
    t_e = 3.841 * s2
    cap = 5.991 * s2
    x1h = jnp.concatenate([xy1, jnp.ones_like(xy1[..., :1])], axis=-1)
    x2h = jnp.concatenate([xy2, jnp.ones_like(xy2[..., :1])], axis=-1)
    l2 = x1h @ E.T  # epiline of x1 in image 2
    l1 = x2h @ E  # epiline of x2 in image 1
    num = jnp.sum(x2h * l2, axis=-1)
    d2_img2 = num**2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-18)
    d2_img1 = num**2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-18)
    se = jnp.sum(
        jnp.where((d2_img1 < t_e) & valid, cap - d2_img1, 0.0)
        + jnp.where((d2_img2 < t_e) & valid, cap - d2_img2, 0.0)
    )
    Hi = jnp.linalg.inv(H + 1e-30 * jnp.eye(3, dtype=H.dtype))
    p2 = x1h @ H.T
    p1 = x2h @ Hi.T
    p2 = p2[..., :2] / jnp.where(
        jnp.abs(p2[..., 2:]) < 1e-12, 1e-12, p2[..., 2:]
    )
    p1 = p1[..., :2] / jnp.where(
        jnp.abs(p1[..., 2:]) < 1e-12, 1e-12, p1[..., 2:]
    )
    dh2 = jnp.sum((p2 - xy2) ** 2, axis=-1)
    dh1 = jnp.sum((p1 - xy1) ** 2, axis=-1)
    sh = jnp.sum(
        jnp.where((dh1 < cap) & valid, cap - dh1, 0.0)
        + jnp.where((dh2 < cap) & valid, cap - dh2, 0.0)
    )
    return se, sh


def _skew(v: jax.Array) -> jax.Array:
    z = jnp.zeros_like(v[..., 0])
    return jnp.stack(
        [
            jnp.stack([z, -v[..., 2], v[..., 1]], -1),
            jnp.stack([v[..., 2], z, -v[..., 0]], -1),
            jnp.stack([-v[..., 1], v[..., 0], z], -1),
        ],
        -2,
    )


@jax.jit
def recover_pose_from_homography(
    H: jax.Array,
    xy1: jax.Array,
    xy2: jax.Array,
    mask: jax.Array,
    mask_all: jax.Array,
    thresh_norm: float | jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """Relative pose from a calibrated homography via the 8 Faugeras
    hypotheses, disambiguated by cheirality + FULL-SET epipolar support.

    The planar two-view problem has a genuine two-fold ambiguity: two of
    the eight (R, t, n) hypotheses interpret the same in-plane flow as
    different rotation/plane combinations, and BOTH pass cheirality on
    the plane's own points (each is an exact, photoconsistent planar
    reconstruction — observed as a recovered trajectory with ~zero
    relative rotation on the 16-view low-texture probe). What breaks the
    tie is OFF-PLANE evidence: a correspondence not on the plane is
    epipolar-consistent only with the true motion. So each hypothesis is
    scored by Sampson-inlier count of its induced essential matrix
    [t]ₓR over ALL tentative matches (mask_all, not just H inliers),
    with the cheirality count as tiebreak for the pure-plane case where
    the ambiguity is fundamental.

    mask: H-inlier set (disambiguation tiebreak support).
    mask_all: full tentative-match set used for disambiguation AND for
    the returned observation mask — the homography only supplies the
    POSE; its inliers are just the plane's points, and returning them as
    the observation set would discard every valid off-plane match
    (observed as starved maps + pose-ratio gate failures on the 8-view
    probe). Like cv2::recoverPose's output mask, the returned inliers
    are the FULL set's Sampson inliers under the winning pose's induced
    essential matrix, intersected with its cheirality.
    Pure-rotation pairs (d1 ≈ d2 ≈ d3) collapse to t ≈ 0 hypotheses whose
    triangulations fail the reprojection gate downstream — they lose the
    model selection, as they should (no parallax, no baseline).
    """
    Rs, ts, _ = decompose_homography(H)
    counts, goods = _candidate_stats(Rs, ts, xy1, xy2, mask)
    Es = _skew(ts) @ Rs  # (8, 3, 3) induced essential matrices
    samp = jax.vmap(lambda E: sampson_error(E, xy1, xy2))(Es)  # (8, N)
    samp_in = (samp <= thresh_norm) & mask_all[None, :] & jnp.isfinite(samp)
    support = jnp.sum(samp_in, axis=1)
    n = xy1.shape[0]
    best = jnp.argmax(support * (n + 1) + counts)
    pose = jnp.concatenate([rotmat_to_aa(Rs[best]), ts[best]])
    return pose, samp_in[best] & goods[best]
