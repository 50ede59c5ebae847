"""Host image utils vs the reference OpenCvUtils semantics
(ref: src/photogrammetrie/util/OpenCvUtils.cpp:93-163, OpenCvUtils.h:194-213)."""

import numpy as np

from sfm_mvs_pipeline.utils.images import (
    scale_letterbox,
    scale_points,
    scaled_intrinsics,
    stereo_matcher_roi,
)


def test_scale_letterbox_preserves_aspect(rng):
    img = (rng.random((40, 80)) * 255).astype(np.uint8)  # 2:1
    out = scale_letterbox(img, (64, 64), fill=7)
    assert out.shape == (64, 64)
    # 80x40 -> fits at 64x32, centered vertically: rows 16..48 are content
    assert (out[:16] == 7).all() and (out[48:] == 7).all()
    assert not (out[16:48] == 7).all()


def test_scale_letterbox_identity():
    img = np.arange(12, dtype=np.uint8).reshape(3, 4)
    out = scale_letterbox(img, (4, 3))
    np.testing.assert_array_equal(out, img)


def test_scale_letterbox_color(rng):
    img = (rng.random((30, 20, 3)) * 255).astype(np.uint8)
    out = scale_letterbox(img, (60, 60), fill=0)
    assert out.shape == (60, 60, 3)
    # 20x30 -> 40x60, centered horizontally: cols 10..50
    assert (out[:, :10] == 0).all() and (out[:, 50:] == 0).all()


def test_scale_points():
    pts = np.array([[2.0, 4.0], [1.0, 3.0]])
    np.testing.assert_allclose(scale_points(pts, 0.5), pts * 0.5)


def test_scaled_intrinsics():
    K = np.array([[500.0, 0, 320], [0, 510, 240], [0, 0, 1]])
    S = scaled_intrinsics(K, 0.25)
    np.testing.assert_allclose(S[:2], K[:2] * 0.25)
    np.testing.assert_allclose(S[2], K[2])
    # input untouched (the reference mutates in place — we do not)
    assert K[0, 0] == 500.0


def test_stereo_matcher_roi_matches_cv2():
    import cv2

    w, h = 320, 240
    min_d, num_d, block = 0, 64, 11
    roi = stereo_matcher_roi((w, h), min_d, num_d, block)
    sm = cv2.StereoBM_create(numDisparities=num_d, blockSize=block)
    sm.setMinDisparity(min_d)
    # reference formula (OpenCvUtils.cpp:148-163)
    half = block // 2
    exp = (min_d + num_d - 1 + half, half, (w + min_d - half) - (min_d + num_d - 1 + half), h - 2 * half)
    assert roi == exp
    assert roi[2] > 0 and roi[3] > 0
