"""ORB frontend: detection + matching quality on real images."""

import numpy as np
import cv2
import jax.numpy as jnp

from sfm_mvs_pipeline.ops.orb import orb_features
from sfm_mvs_pipeline.ops.matching import (
    expand_binary_descriptors,
    ratio_test_mask,
    two_nn_jnp,
)


def _insel(n=2):
    import os

    base = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "sample_data", "insel",
    )
    from sfm_mvs_pipeline.utils.images import load_gray_batch

    imgs, _ = load_gray_batch(
        [os.path.join(base, f"{i}.png") for i in range(1, n + 1)]
    )
    return np.round(imgs * 255.0).astype(np.uint8)


def test_orb_detects_and_matches_insel():
    imgs = _insel(2)
    out = orb_features(jnp.asarray(imgs), max_features=512)
    valid = np.asarray(out["valid"])
    assert valid.sum(axis=1).min() > 300, valid.sum(axis=1)
    assert out["descriptors"].shape == (2, 512, 32)

    e0 = expand_binary_descriptors(out["descriptors"][0])
    e1 = expand_binary_descriptors(out["descriptors"][1])
    bi, bsq, ssq = two_nn_jnp(
        e0, e1, out["valid"][0], out["valid"][1]
    )
    # Hamming ratio test (|a-b|^2 = 4*ham preserves ratios)
    mask = np.asarray(ratio_test_mask(bsq, ssq, out["valid"][0], ratio=0.8))
    n_matches = int(mask.sum())
    assert n_matches > 60, n_matches

    # geometric consistency of the matches
    kq = np.asarray(out["keypoints"][0])[mask]
    kt = np.asarray(out["keypoints"][1])[np.asarray(bi)[mask]]
    H, inl = cv2.findHomography(kq, kt, cv2.RANSAC, 5.0)
    assert inl is not None and inl.sum() / len(kq) > 0.6, (
        f"{int(inl.sum() if inl is not None else 0)}/{len(kq)}"
    )


def test_orb_rotation_invariance(rng):
    """Descriptors should survive a 30-degree in-plane rotation."""
    img = _insel(1)[0]
    h, w = img.shape
    M = cv2.getRotationMatrix2D((w / 2, h / 2), 30, 1.0)
    rot = cv2.warpAffine(img, M, (w, h))
    out = orb_features(jnp.asarray(np.stack([img, rot])), max_features=512)
    e0 = expand_binary_descriptors(out["descriptors"][0])
    e1 = expand_binary_descriptors(out["descriptors"][1])
    bi, bsq, ssq = two_nn_jnp(e0, e1, out["valid"][0], out["valid"][1])
    mask = np.asarray(ratio_test_mask(bsq, ssq, out["valid"][0], ratio=0.8))
    assert mask.sum() > 40, int(mask.sum())

    kq = np.asarray(out["keypoints"][0])[mask]
    kt = np.asarray(out["keypoints"][1])[np.asarray(bi)[mask]]
    # matched points should map under the known rotation
    kq_h = np.hstack([kq, np.ones((len(kq), 1))])
    pred = kq_h @ M.T
    err = np.linalg.norm(pred - kt, axis=1)
    assert np.median(err) < 3.0, np.median(err)
