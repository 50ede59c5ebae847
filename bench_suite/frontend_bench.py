"""Feature-frontend quality vs the cv2.SIFT oracle on the insel frames.

Quantifies what PARITY.md row 22 left open (VERDICT r2 weak #3): keypoint
counts, repeatability (mutual 2 px localization agreement), and post-ratio
match recall of ops/sift.py against cv2.SIFT with the reference's
parameters (nfeatures limit, 3 layers, contrastThreshold 0.09 —
PhotogrammetrieCli.cpp:354). Match recall counts a cv2 match (a->b) as
recalled when this pipeline produced a match whose endpoints are within
3 px of it.

Run directly: python bench_suite/frontend_bench.py  (any backend)
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def load_images():
    """The bundled insel frames as a (3, H, W) uint8 gray stack."""
    from sfm_mvs_pipeline.utils.images import list_images, load_gray_batch

    base = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "sample_data", "insel")
    imgs, _ = load_gray_batch(list_images(base))
    return base, np.round(imgs * 255.0).astype(np.uint8)


def frontend_quality(imgs, limit=10000):
    import cv2
    import jax.numpy as jnp

    from sfm_mvs_pipeline.ops.matching import (
        ratio_test_mask,
        two_nn_jnp,
    )
    from sfm_mvs_pipeline.ops.sift import sift_features

    sift = cv2.SIFT_create(
        nfeatures=limit, nOctaveLayers=3, contrastThreshold=0.09
    )
    cv_kp, cv_desc = [], []
    for img in imgs:
        kp, ds = sift.detectAndCompute(img, None)
        cv_kp.append(np.array([k.pt for k in kp]))
        cv_desc.append(ds)

    cap = 256
    while cap < min(limit, 8192):
        cap *= 2
    feats = sift_features(
        jnp.asarray(imgs.astype(np.float32) / 255.0),
        max_features=cap, contrast_threshold=0.09,
    )
    our_kp = np.asarray(feats["keypoints"])
    our_valid = np.asarray(feats["valid"])
    our_desc = np.asarray(feats["descriptors"])

    out = {"per_image": []}
    for i in range(len(imgs)):
        ours = our_kp[i][our_valid[i]]
        theirs = cv_kp[i]
        # repeatability: mutual 2 px agreement
        d = np.linalg.norm(ours[:, None] - theirs[None], axis=2)
        rep_ours = (d.min(axis=1) < 2.0).mean() if len(ours) else 0.0
        rep_theirs = (d.min(axis=0) < 2.0).mean() if len(theirs) else 0.0
        out["per_image"].append({
            "n_ours": int(len(ours)), "n_cv2": int(len(theirs)),
            "ours_kp_near_cv2": round(float(rep_ours), 3),
            "cv2_kp_near_ours": round(float(rep_theirs), 3),
        })

    # post-ratio match recall on the first pair
    bf = cv2.BFMatcher(cv2.NORM_L2)
    knn = bf.knnMatch(cv_desc[0], cv_desc[1], k=2)
    cv_matches = [
        (cv_kp[0][m.queryIdx], cv_kp[1][m.trainIdx])
        for m, n in (p for p in knn if len(p) == 2)
        if m.distance < 0.7 * n.distance
    ]
    bi, bd, sd = two_nn_jnp(
        jnp.asarray(our_desc[0]), jnp.asarray(our_desc[1]),
        jnp.asarray(our_valid[0]), jnp.asarray(our_valid[1]),
    )
    mask = np.asarray(ratio_test_mask(bd, sd, jnp.asarray(our_valid[0])))
    bi = np.asarray(bi)
    ours_matches = [
        (our_kp[0][q], our_kp[1][bi[q]]) for q in np.nonzero(mask)[0]
    ]
    recalled = 0
    for ua, ub in cv_matches:
        for va, vb in ours_matches:
            if np.linalg.norm(ua - va) < 3 and np.linalg.norm(ub - vb) < 3:
                recalled += 1
                break
    out["pair01_cv2_matches"] = len(cv_matches)
    out["pair01_our_matches"] = len(ours_matches)
    out["pair01_match_recall_vs_cv2"] = round(
        recalled / max(len(cv_matches), 1), 3
    )
    return out


def main():
    base, imgs = load_images()
    print(f"dataset: {base}  {imgs.shape}")
    q = frontend_quality(imgs)
    for i, row in enumerate(q["per_image"]):
        print(f"image {i}: {row}")
    print(
        f"pair (0,1): cv2 {q['pair01_cv2_matches']} matches, "
        f"ours {q['pair01_our_matches']} matches, "
        f"recall vs cv2 {q['pair01_match_recall_vs_cv2']}"
    )


if __name__ == "__main__":
    main()
