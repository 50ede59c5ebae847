"""Batched-hypothesis RANSAC harness.

Batched replacement for OpenCV's early-exit RANSAC loops
(cv::findHomography / cv::findEssentialMat / cv::solvePnPRansac call sites:
src/photogrammetrie/sfm/SfM.cpp:617-637, :525-528, :478).

Design: instead of a sequential hypothesize-verify loop with early exit,
draw a FIXED batch of K hypotheses, solve all minimal problems with one
vmapped solver, score all K x N residuals in one batched pass, and argmax
the inlier count. Fixed iteration counts + masks keep shapes static for XLA;
degenerate samples simply score 0. This trades a constant factor of extra
FLOPs for full data-parallel utilization of the device.

Shared helpers here; the estimators live in homography.py / epipolar.py /
pnp.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sample_valid_indices(
    key: jax.Array, valid: jax.Array, k_hyp: int, m: int
) -> jax.Array:
    """Draw (k_hyp, m) indices uniformly from the True entries of `valid`.

    Works under jit with a traced valid-count: valid entries are compacted to
    the front by a stable argsort on ~valid, then positions are drawn modulo
    the count. Duplicate indices within a sample are possible but rare and
    only waste the affected hypothesis.
    """
    n = valid.shape[0]
    order = jnp.argsort(~valid, stable=True)  # valid indices first
    count = jnp.maximum(jnp.sum(valid), 1)
    u = jax.random.uniform(key, (k_hyp, m))
    pos = jnp.minimum((u * count).astype(jnp.int32), count - 1)
    return order[pos]


def inlier_counts(residuals: jax.Array, valid: jax.Array, thresh: jax.Array) -> jax.Array:
    """Count inliers per hypothesis. residuals: (K, N), valid: (N,)."""
    ok = (residuals <= thresh) & valid[None, :] & jnp.isfinite(residuals)
    return jnp.sum(ok, axis=1)


def select_best(
    models: jax.Array, residuals: jax.Array, valid: jax.Array, thresh: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Pick the hypothesis with the most inliers.

    models: (K, ...), residuals: (K, N). Returns (best_model, inlier_mask (N,),
    inlier_count scalar).
    """
    counts = inlier_counts(residuals, valid, thresh)
    best = jnp.argmax(counts)
    best_res = residuals[best]
    mask = (best_res <= thresh) & valid & jnp.isfinite(best_res)
    return models[best], mask, counts[best]


def resolve_threshold(
    thresh_param: float, image_max_dim: float
) -> float:
    """Reference sign convention for RANSAC thresholds: a negative value is
    an absolute pixel threshold (times -1); a positive value is a fraction of
    the max image dimension. (ref: src/photogrammetrie/sfm/SfM.cpp:471-473,
    :517-520, :617-620)
    """
    if thresh_param < 0:
        return -thresh_param
    return thresh_param * image_max_dim
