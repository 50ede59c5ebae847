"""Batched RANSAC homography estimation.

Replaces cv::findHomography(RANSAC) as used for pair ordering by homography
inlier ratio (ref: src/photogrammetrie/sfm/SfM.cpp:599-637). The reference
only consumes the INLIER RATIO (low ratio == high parallax == good baseline
pair), so fidelity target is the ratio, not the H matrix itself.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from sfm_mvs_pipeline.ops.ransac import sample_valid_indices, select_best


def _normalize_points(pts: jax.Array, valid: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Hartley normalization: similarity T s.t. centroid 0, mean dist sqrt(2)."""
    w = valid.astype(pts.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(pts * w[:, None], axis=0) / n
    d = jnp.sqrt(jnp.sum((pts - mean) ** 2, axis=-1) + 1e-12)
    scale = jnp.sqrt(2.0) / jnp.maximum(jnp.sum(d * w) / n, 1e-12)
    T = jnp.array(
        [
            [scale, 0.0, -scale * mean[0]],
            [0.0, scale, -scale * mean[1]],
            [0.0, 0.0, 1.0],
        ],
        dtype=pts.dtype,
    )
    pn = (pts - mean) * scale
    return pn, T


def _dlt_h(p1: jax.Array, p2: jax.Array) -> jax.Array:
    """4+ point DLT: homography p2 ~ H p1. p1, p2: (M, 2). Returns (3, 3)."""
    m = p1.shape[0]
    x, y = p1[:, 0], p1[:, 1]
    u, v = p2[:, 0], p2[:, 1]
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    r1 = jnp.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], axis=1)
    r2 = jnp.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], axis=1)
    A = jnp.concatenate([r1, r2], axis=0)  # (2M, 9)
    AtA = A.T @ A
    _, vecs = jnp.linalg.eigh(AtA)
    h = vecs[:, 0]
    return h.reshape(3, 3)


def _apply_h(H: jax.Array, pts: jax.Array) -> jax.Array:
    ph = jnp.concatenate([pts, jnp.ones_like(pts[..., :1])], axis=-1)
    q = ph @ H.T
    w = q[..., 2]
    w_safe = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return q[..., :2] / w_safe[..., None]


@functools.partial(jax.jit, static_argnames=("k_hyp",))
def find_homography_ransac(
    key: jax.Array,
    pts1: jax.Array,
    pts2: jax.Array,
    valid: jax.Array,
    thresh: float | jax.Array,
    k_hyp: int = 256,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """RANSAC homography. pts: (N, 2) pixels, valid: (N,) bool.

    Returns (H (3,3), inlier_mask (N,), inlier_count). Residual = forward
    transfer error |H p1 - p2| (what cv::findHomography RANSAC scores).
    """
    idx = sample_valid_indices(key, valid, k_hyp, 4)  # (K, 4)

    def solve(sample_idx):
        return _dlt_h(pts1[sample_idx], pts2[sample_idx])

    Hs = jax.vmap(solve)(idx)  # (K, 3, 3)
    proj = jax.vmap(lambda H: _apply_h(H, pts1))(Hs)  # (K, N, 2)
    res = jnp.linalg.norm(proj - pts2[None], axis=-1)
    H, mask, count = select_best(Hs, res, valid, thresh)

    # Least-squares refinement on inliers (normalized DLT weighted by mask),
    # then re-score — mirrors cv's final LS polish.
    p1n, T1 = _normalize_points(pts1, mask)
    p2n, T2 = _normalize_points(pts2, mask)
    w = mask.astype(pts1.dtype)
    x, y = p1n[:, 0], p1n[:, 1]
    u, v = p2n[:, 0], p2n[:, 1]
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    r1 = jnp.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], axis=1)
    r2 = jnp.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], axis=1)
    A = jnp.concatenate([r1 * w[:, None], r2 * w[:, None]], axis=0)
    AtA = A.T @ A
    _, vecs = jnp.linalg.eigh(AtA)
    Hn = vecs[:, 0].reshape(3, 3)
    H_ref = jnp.linalg.solve(T2, Hn @ T1)
    res_ref = jnp.linalg.norm(_apply_h(H_ref, pts1) - pts2, axis=-1)
    mask_ref = (res_ref <= thresh) & valid & jnp.isfinite(res_ref)
    count_ref = jnp.sum(mask_ref)

    better = count_ref >= count
    H_out = jnp.where(better, H_ref, H)
    mask_out = jnp.where(better, mask_ref, mask)
    return H_out, mask_out, jnp.maximum(count_ref, count)


@functools.partial(jax.jit, static_argnames=("k_hyp",))
def homography_inlier_ratio(
    key: jax.Array,
    pts1: jax.Array,
    pts2: jax.Array,
    valid: jax.Array,
    thresh: float | jax.Array,
    k_hyp: int = 256,
) -> jax.Array:
    """Inlier ratio = inliers / total matches (the pair-ordering metric;
    ref: SfM.cpp:630-633). Pairs with < 4 matches get ratio 0."""
    _, _, count = find_homography_ransac(key, pts1, pts2, valid, thresh, k_hyp)
    total = jnp.sum(valid)
    enough = total >= 4
    return jnp.where(enough, count / jnp.maximum(total, 1), 0.0)
