"""Feature-frontend quality gates vs the cv2.SIFT oracle.

Pins the frontend-quality numbers on the bundled insel frames: keypoint count within the
same regime as cv2, high mutual localization agreement, and most of cv2's
post-ratio matches recovered. Uses bench_suite/frontend_bench.py so the
test and the published numbers share one implementation.
"""

import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def test_sift_frontend_quality_vs_cv2():
    from bench_suite.frontend_bench import frontend_quality, load_images

    _, imgs = load_images()
    q = frontend_quality(imgs, limit=2048)
    for row in q["per_image"]:
        # detections in the same regime as cv2 (not an order off)
        assert row["n_ours"] > 0.5 * row["n_cv2"], row
        assert row["n_ours"] < 2.0 * row["n_cv2"], row
        # localization: most cv2 keypoints have one of ours within 2 px
        assert row["cv2_kp_near_ours"] > 0.85, row
    assert q["pair01_match_recall_vs_cv2"] > 0.6, q
