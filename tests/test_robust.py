"""RANSAC estimators vs OpenCV oracles on synthetic data with outliers."""

import numpy as np
import cv2
import jax
import jax.numpy as jnp

from sfm_mvs_pipeline.ops.homography import (
    find_homography_ransac,
    homography_inlier_ratio,
)
from sfm_mvs_pipeline.ops.epipolar import (
    find_essential_ransac,
    recover_pose,
    sampson_error,
)
from sfm_mvs_pipeline.ops.pnp import solve_pnp_ransac
from sfm_mvs_pipeline.ops.pose import aa_to_rotmat, camera_center


def test_homography_ransac(rng):
    H_true = np.array([[1.1, 0.05, 20.0], [-0.03, 0.95, -10.0], [1e-4, -5e-5, 1.0]])
    n = 200
    p1 = rng.uniform(0, 600, size=(n, 2))
    p1h = np.hstack([p1, np.ones((n, 1))])
    p2 = (p1h @ H_true.T)
    p2 = p2[:, :2] / p2[:, 2:3]
    p2 += rng.normal(size=(n, 2)) * 0.3
    p2[:50] = rng.uniform(0, 600, size=(50, 2))  # 25% outliers
    valid = np.ones(n, bool)

    H, mask, count = find_homography_ransac(
        jax.random.key(0), jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid), 3.0
    )
    mask = np.asarray(mask)
    assert mask[50:].sum() > 140  # most true inliers found
    assert mask[:50].sum() < 8
    # H agrees with truth up to scale on inliers
    Hn = np.asarray(H) / np.asarray(H)[2, 2]
    np.testing.assert_allclose(Hn, H_true, rtol=0.05, atol=0.5)

    ratio = float(
        homography_inlier_ratio(
            jax.random.key(0), jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid), 3.0
        )
    )
    assert 0.6 < ratio < 0.85


def _two_view_scene(rng, n=300, outliers=60):
    f, cx, cy = 500.0, 320.0, 240.0
    pts = rng.uniform(-2, 2, size=(n, 3))
    pts[:, 2] += 6.0
    R = cv2.Rodrigues(np.array([0.05, 0.25, -0.02]))[0]
    t = np.array([1.2, -0.1, 0.15])
    t = t / np.linalg.norm(t)
    uv1 = pts[:, :2] / pts[:, 2:3] * f + [cx, cy]
    pc2 = pts @ R.T + t
    uv2 = pc2[:, :2] / pc2[:, 2:3] * f + [cx, cy]
    uv1 += rng.normal(size=(n, 2)) * 0.3
    uv2 += rng.normal(size=(n, 2)) * 0.3
    uv2[:outliers] = rng.uniform(0, 640, size=(outliers, 2))
    return pts, R, t, uv1, uv2, (f, cx, cy)


def test_essential_and_recover_pose(rng):
    pts, R_true, t_true, uv1, uv2, (f, cx, cy) = _two_view_scene(rng)
    xy1 = (uv1 - [cx, cy]) / f
    xy2 = (uv2 - [cx, cy]) / f
    valid = np.ones(len(uv1), bool)
    thresh_norm = 2.0 / f

    E, mask, count = find_essential_ransac(
        jax.random.key(1), jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(valid),
        thresh_norm,
    )
    mask_np = np.asarray(mask)
    assert mask_np[60:].sum() > 200
    assert mask_np[:60].sum() < 10

    pose, mask2 = recover_pose(E, jnp.asarray(xy1), jnp.asarray(xy2), mask)
    R_est = np.asarray(aa_to_rotmat(pose[:3]))
    t_est = np.asarray(pose[3:])
    # rotation error
    cos = (np.trace(R_est @ R_true.T) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 1.0
    # translation direction error (sign-fixed unit vector)
    tdir = t_est / np.linalg.norm(t_est)
    assert min(
        np.linalg.norm(tdir - t_true), np.linalg.norm(tdir + t_true)
    ) < 0.05


def _planar_two_view_scene(rng, n=150):
    """Points on ONE plane — the 8-point essential degeneracy regime
    (the regime of the 16-view low-texture boundary: the photo plane
    fills the view)."""
    f, cx, cy = 400.0, 200.0, 150.0
    xy = rng.uniform(-2, 2, size=(n, 2))
    pts = np.column_stack([xy[:, 0], xy[:, 1], np.full(n, 8.0)])
    R = cv2.Rodrigues(np.array([0.03, 0.2, -0.01]))[0]
    t = np.array([1.5, 0.1, 0.05])
    uv1 = pts[:, :2] / pts[:, 2:3] * f + [cx, cy]
    pc2 = pts @ R.T + t
    uv2 = pc2[:, :2] / pc2[:, 2:3] * f + [cx, cy]
    uv1 += rng.normal(size=(n, 2)) * 0.2
    uv2 += rng.normal(size=(n, 2)) * 0.2
    return pts, R, t / np.linalg.norm(t), uv1, uv2, (f, cx, cy)


def test_decompose_homography_recovers_planar_pose(rng):
    """Faugeras decomposition + cheirality must recover the true motion
    from a calibrated homography of a planar scene."""
    from sfm_mvs_pipeline.ops.epipolar import recover_pose_from_homography

    pts, R_true, t_true, uv1, uv2, (f, cx, cy) = _planar_two_view_scene(rng)
    xy1 = (uv1 - [cx, cy]) / f
    xy2 = (uv2 - [cx, cy]) / f
    valid = np.ones(len(uv1), bool)
    H, hmask, _ = find_homography_ransac(
        jax.random.key(5), jnp.asarray(xy1), jnp.asarray(xy2),
        jnp.asarray(valid), 2.0 / f,
    )
    assert int(np.asarray(hmask).sum()) > 120  # planar: near-full support
    pose, mask2 = recover_pose_from_homography(
        H, jnp.asarray(xy1), jnp.asarray(xy2), hmask,
        jnp.asarray(valid), 2.0 / f,
    )
    R_est = np.asarray(aa_to_rotmat(pose[:3]))
    t_est = np.asarray(pose[3:])
    cos = (np.trace(R_est @ R_true.T) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 1.0
    tdir = t_est / np.linalg.norm(t_est)
    assert min(
        np.linalg.norm(tdir - t_true), np.linalg.norm(tdir + t_true)
    ) < 0.05


def test_planar_pair_pose_model_selection(rng):
    """The driver's E-vs-H model selection must survive the planar scene
    that breaks the 8-point essential path (any E = [v]x H fits coplanar
    points exactly, so RANSAC support cannot flag the failure)."""
    from sfm_mvs_pipeline.sfm.incremental import _pair_pose_jit

    pts, R_true, t_true, uv1, uv2, (f, cx, cy) = _planar_two_view_scene(rng)
    n = len(uv1)
    intr = jnp.asarray([f, cx, cy, 0, 0, 0, 0], jnp.float64)
    idx = np.arange(n, dtype=np.int32)
    pose, em = _pair_pose_jit(
        jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(idx),
        jnp.ones(n, bool), intr, intr, 2.0, jax.random.key(7),
    )
    R_est = np.asarray(aa_to_rotmat(pose[:3]))
    t_est = np.asarray(pose[3:])
    cos = (np.trace(R_est @ R_true.T) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 1.5
    tdir = t_est / np.linalg.norm(t_est)
    assert min(
        np.linalg.norm(tdir - t_true), np.linalg.norm(tdir + t_true)
    ) < 0.08
    assert int(np.asarray(em).sum()) > 100


def test_sampson_zero_for_perfect_points(rng):
    pts, R, t, uv1, uv2, (f, cx, cy) = _two_view_scene(rng, outliers=0)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = tx @ R
    xy1 = (uv1 - [cx, cy]) / f
    xy2 = (uv2 - [cx, cy]) / f
    err = np.asarray(sampson_error(jnp.asarray(E), jnp.asarray(xy1), jnp.asarray(xy2)))
    assert np.median(err) < 2.0 / f  # noise-level


def test_two_view_model_scores_direction(rng):
    """S_H/(S_H+S_E) must exceed 0.45 on a planar scene (both models
    explain everything) and stay below it with genuine parallax (H only
    explains the dominant plane's subset)."""
    from sfm_mvs_pipeline.ops.epipolar import two_view_model_scores

    def scores(planar):
        if planar:
            pts, R, t, uv1, uv2, (f, cx, cy) = _planar_two_view_scene(rng)
        else:
            pts, R, t, uv1, uv2, (f, cx, cy) = _two_view_scene(
                rng, outliers=0
            )
        xy1 = (uv1 - [cx, cy]) / f
        xy2 = (uv2 - [cx, cy]) / f
        valid = np.ones(len(uv1), bool)
        tn = 1.0 / f
        key = jax.random.key(4)
        ke, kh = jax.random.split(key)
        E, _, _ = find_essential_ransac(
            ke, jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(valid), tn
        )
        H, _, _ = find_homography_ransac(
            kh, jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(valid), tn
        )
        se, sh = two_view_model_scores(
            E, H, jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(valid), tn
        )
        return float(sh / (sh + se))

    assert scores(planar=True) > 0.45
    assert scores(planar=False) < 0.45


def test_pnp_ransac_planar_map(rng):
    """PnP must register a view against a COPLANAR 3D map (6-point DLT
    alone is rank-deficient there; the planar 4-point homography family
    carries it — the regime of the quasi-planar low-texture maps)."""
    f, cx, cy = 400.0, 200.0, 150.0
    intr = jnp.asarray([f, cx, cy, 0, 0, 0, 0], dtype=jnp.float64)
    n = 120
    xy = rng.uniform(-3, 3, size=(n, 2))
    pts = np.column_stack([xy[:, 0], xy[:, 1], np.full(n, 9.0)])
    rvec_true = np.array([0.05, -0.2, 0.02])
    tvec_true = np.array([0.8, -0.1, 0.3])
    R = cv2.Rodrigues(rvec_true)[0]
    pc = pts @ R.T + tvec_true
    uv = pc[:, :2] / pc[:, 2:3] * f + [cx, cy]
    uv += rng.normal(size=(n, 2)) * 0.3
    uv[:20] = rng.uniform(0, 400, size=(20, 2))  # outliers

    pose, mask, ratio = solve_pnp_ransac(
        jax.random.key(9), jnp.asarray(pts), jnp.asarray(uv), intr,
        jnp.ones(n, bool), 3.0,
    )
    pose = np.asarray(pose)
    np.testing.assert_allclose(pose[:3], rvec_true, atol=5e-3)
    np.testing.assert_allclose(pose[3:], tvec_true, atol=3e-2)
    assert float(ratio) > 0.7


def test_pnp_ransac_vs_opencv(rng):
    f, cx, cy = 500.0, 320.0, 240.0
    intr = jnp.asarray([f, cx, cy, -0.05, 0.01, 0, 0], dtype=jnp.float64)
    n = 250
    pts = rng.uniform(-2, 2, size=(n, 3))
    pts[:, 2] += 6.0
    rvec_true = np.array([0.1, -0.3, 0.05])
    tvec_true = np.array([0.4, 0.2, 0.5])
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]])
    dist = np.array([-0.05, 0.01, 0, 0])
    uv, _ = cv2.projectPoints(pts.reshape(-1, 1, 3), rvec_true, tvec_true, K, dist)
    uv = uv.reshape(-1, 2) + rng.normal(size=(n, 2)) * 0.4
    uv[:50] = rng.uniform(0, 640, size=(50, 2))

    pose, mask, ratio = solve_pnp_ransac(
        jax.random.key(2), jnp.asarray(pts), jnp.asarray(uv), intr,
        jnp.ones(n, bool), 3.0,
    )
    pose = np.asarray(pose)
    np.testing.assert_allclose(pose[:3], rvec_true, atol=2e-3)
    np.testing.assert_allclose(pose[3:], tvec_true, atol=1e-2)
    assert float(ratio) > 0.75
    assert np.asarray(mask)[:50].sum() < 5
