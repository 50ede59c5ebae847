"""Camera model projection/undistortion vs OpenCV oracles."""

import numpy as np
import cv2
import jax.numpy as jnp

from sfm_mvs_pipeline.models import cameras as C
from sfm_mvs_pipeline.ops.pose import aa_to_rotmat


def _cv_project(pts3d, rvec, tvec, intr):
    K = np.array(
        [[intr[0], 0, intr[1]], [0, intr[0], intr[2]], [0, 0, 1]], dtype=np.float64
    )
    dist = np.array([intr[3], intr[4], intr[5], intr[6]], dtype=np.float64)
    uv, _ = cv2.projectPoints(pts3d.reshape(-1, 1, 3), rvec, tvec, K, dist)
    return uv.reshape(-1, 2)


def test_project_matches_opencv_all_models(rng):
    pts = rng.uniform(-1, 1, size=(200, 3))
    pts[:, 2] += 5.0
    rvec = np.array([0.1, -0.2, 0.05])
    tvec = np.array([0.3, -0.1, 0.2])
    pose = jnp.asarray(np.concatenate([rvec, tvec]), dtype=jnp.float64)

    for intr_np in [
        np.array([500.0, 320, 240, 0, 0, 0, 0]),  # simple
        np.array([500.0, 320, 240, -0.1, 0.02, 0, 0]),  # simple-radial
        np.array([510.0, 315, 245, -0.15, 0.03, 0.001, -0.002]),  # distortion
    ]:
        intr = jnp.asarray(intr_np, dtype=jnp.float64)
        uv, z = C.project_points(pose, intr, jnp.asarray(pts))
        uv_cv = _cv_project(pts, rvec, tvec, intr_np)
        np.testing.assert_allclose(np.asarray(uv), uv_cv, atol=1e-6)
        assert np.all(np.asarray(z) > 0)


def test_undistort_matches_opencv(rng):
    intr_np = np.array([500.0, 320, 240, -0.2, 0.05, 0.001, -0.001])
    intr = jnp.asarray(intr_np, dtype=jnp.float64)
    uv = rng.uniform([50, 50], [590, 430], size=(100, 2))
    ours = np.asarray(C.undistort_points(intr, jnp.asarray(uv), num_iters=20))

    K = np.array(
        [[intr_np[0], 0, intr_np[1]], [0, intr_np[0], intr_np[2]], [0, 0, 1]]
    )
    dist = np.array([intr_np[3], intr_np[4], intr_np[5], intr_np[6]])
    cv_out = cv2.undistortPoints(
        uv.reshape(-1, 1, 2).astype(np.float64), K, dist
    ).reshape(-1, 2)
    np.testing.assert_allclose(ours, cv_out, atol=1e-5)


def test_distort_undistort_roundtrip(rng):
    intr = jnp.asarray([500.0, 320, 240, -0.2, 0.05, 0.001, -0.001], dtype=jnp.float64)
    uv = jnp.asarray(rng.uniform([100, 100], [540, 380], size=(50, 2)))
    xy = C.undistort_points(intr, uv, num_iters=20)
    uv_back = C.normalized_to_pixels(intr, C.distort_normalized(intr, xy))
    np.testing.assert_allclose(np.asarray(uv_back), np.asarray(uv), atol=1e-6)


def test_intrinsics_init():
    intr = C.make_intrinsics(720, 405)
    assert float(intr[0]) == 1.2 * 720
    assert float(intr[1]) == 360.0 and float(intr[2]) == 202.5


def test_camera_model_masks():
    assert C.CAMERA_MODELS["simple"].opt_mask == (0,)
    assert C.CAMERA_MODELS["simple-radial"].opt_mask == (0, 3, 4)
    assert len(C.CAMERA_MODELS["distortion"].opt_mask) == 7


def test_f32_projection_accuracy(rng):
    """Device dtype sanity: f32 projection within 1e-2 px of f64."""
    pts = rng.uniform(-1, 1, size=(500, 3))
    pts[:, 2] += 5.0
    pose64 = jnp.asarray(rng.normal(size=6) * 0.3, dtype=jnp.float64)
    intr64 = jnp.asarray([800.0, 360, 202.5, -0.1, 0.01, 0, 0], dtype=jnp.float64)
    uv64, _ = C.project_points(pose64, intr64, jnp.asarray(pts, dtype=jnp.float64))
    uv32, _ = C.project_points(
        pose64.astype(jnp.float32),
        intr64.astype(jnp.float32),
        jnp.asarray(pts, dtype=jnp.float32),
    )
    assert float(jnp.max(jnp.abs(uv64 - uv32.astype(jnp.float64)))) < 1e-2
