"""Bundle adjustment: synthetic perturb-and-recover tests."""

import numpy as np
import jax.numpy as jnp

from sfm_mvs_pipeline.sfm.ba import (
    BAConfig,
    build_track_table,
    run_bundle_adjustment,
)
from sfm_mvs_pipeline.ops.pose import rotmat_to_aa
from sfm_mvs_pipeline.models.cameras import CAMERA_MODELS


def _scene_arrays(synthetic_scene, rng, noise_pts=0.05, noise_pose=0.01):
    s = synthetic_scene
    n_cams = len(s["poses"])
    n_pts = len(s["points"])

    poses = []
    for R, t in s["poses"]:
        poses.append(np.concatenate([np.asarray(rotmat_to_aa(jnp.asarray(R))), t]))
    poses = np.stack(poses)

    obs_point = np.tile(np.arange(n_pts), n_cams)
    obs_shot = np.repeat(np.arange(n_cams), n_pts)
    obs_uv = np.concatenate(s["obs"], axis=0)
    obs_w = np.ones(len(obs_uv))

    pts_noisy = s["points"] + rng.normal(size=(n_pts, 3)) * noise_pts
    poses_noisy = poses.copy()
    poses_noisy[1:] += rng.normal(size=(n_cams - 1, 6)) * noise_pose

    intr = s["intr"][None, :].copy()
    cam_of_shot = np.zeros(n_cams, dtype=np.int32)
    return pts_noisy, poses_noisy, intr, cam_of_shot, obs_point, obs_shot, obs_uv, obs_w


def test_track_table():
    obs_point = np.array([0, 0, 1, 2, 2, 2])
    obs_w = np.array([1, 1, 1, 1, 0, 1.0])
    tab = build_track_table(obs_point, obs_w, 3)
    assert tab.shape[1] >= 3
    assert set(tab[0][tab[0] >= 0]) == {0, 1}
    assert set(tab[2][tab[2] >= 0]) == {3, 5}  # dead obs 4 excluded


def test_ba_recovers_perturbed_scene(synthetic_scene, rng):
    arrays = _scene_arrays(synthetic_scene, rng)
    intr_mask = np.zeros((1, 7))
    intr_mask[0, list(CAMERA_MODELS["simple-radial"].opt_mask)] = 1.0

    out = run_bundle_adjustment(
        *arrays, intr_mask=intr_mask, config=BAConfig(max_iterations=30)
    )
    # perfect observations -> cost should collapse to ~0 (px^2 units)
    n_obs = len(arrays[6])
    rms = np.sqrt(2 * out["cost"] / n_obs)
    assert rms < 0.05, f"rms reprojection {rms}"
    assert out["iterations"] <= 30


def test_ba_with_noisy_observations(synthetic_scene, rng):
    arrays = list(_scene_arrays(synthetic_scene, rng))
    arrays[6] = arrays[6] + rng.normal(size=arrays[6].shape) * 0.5  # 0.5 px noise
    intr_mask = np.zeros((1, 7))
    intr_mask[0, 0] = 1.0  # simple model: f only

    out = run_bundle_adjustment(
        *arrays, intr_mask=intr_mask, config=BAConfig(max_iterations=30)
    )
    n_obs = len(arrays[6])
    rms = np.sqrt(2 * out["cost"] / n_obs)
    assert 0.3 < rms < 0.8  # should settle at the noise floor
    # intrinsics stayed a valid simple camera: distortion untouched
    np.testing.assert_array_equal(out["intrinsics"][0, 3:], np.zeros(4))


def test_ba_respects_pose_freeze(synthetic_scene, rng):
    arrays = _scene_arrays(synthetic_scene, rng)
    intr_mask = np.zeros((1, 7))
    pose_free = np.ones(len(arrays[1]))
    pose_free[0] = 0.0
    before = arrays[1][0].copy()
    out = run_bundle_adjustment(
        *arrays,
        intr_mask=intr_mask,
        pose_free=pose_free,
        config=BAConfig(max_iterations=10),
    )
    np.testing.assert_array_equal(out["poses"][0], before)


def test_ba_f32_device_dtype(synthetic_scene, rng):
    """The device path: all-f32 arrays still converge to sub-pixel rms."""
    arrays = [
        a.astype(np.float32) if a.dtype.kind == "f" else a
        for a in _scene_arrays(synthetic_scene, rng)
    ]
    intr_mask = np.zeros((1, 7), dtype=np.float32)
    intr_mask[0, 0] = 1.0
    out = run_bundle_adjustment(
        *arrays, intr_mask=intr_mask, config=BAConfig(max_iterations=30)
    )
    rms = np.sqrt(2 * out["cost"] / len(arrays[6]))
    assert rms < 0.3, f"f32 rms {rms}"


def test_ba_device_matches_host_solver(synthetic_scene, rng):
    """The fused on-device LM (f32 equilibrated Cholesky) must land on the
    same optimum as the conservative host-f64 driver."""
    arrays = _scene_arrays(synthetic_scene, rng)
    intr_mask = np.zeros((1, 7))
    intr_mask[0, list(CAMERA_MODELS["simple-radial"].opt_mask)] = 1.0

    host = run_bundle_adjustment(
        *[a.copy() for a in arrays], intr_mask=intr_mask,
        config=BAConfig(max_iterations=30, solver="host"),
    )
    dev = run_bundle_adjustment(
        *[a.astype(np.float32) if a.dtype.kind == "f" else a for a in arrays],
        intr_mask=intr_mask,
        config=BAConfig(max_iterations=30, solver="device"),
    )
    n_obs = len(arrays[6])
    rms_host = np.sqrt(2 * host["cost"] / n_obs)
    rms_dev = np.sqrt(2 * dev["cost"] / n_obs)
    assert rms_dev < max(2 * rms_host, 0.05), (rms_dev, rms_host)
    # recovered geometry agrees (perfect-observation scene, both near GT)
    np.testing.assert_allclose(dev["poses"], host["poses"], atol=2e-3)


def test_ba_shot_bucket_padding(synthetic_scene, rng):
    """5 real shots pad to the 6-shot bucket: padded shots stay exactly
    frozen and the result matches the unpadded problem."""
    from sfm_mvs_pipeline.sfm.ba import _shot_bucket

    assert _shot_bucket(5) == 6
    arrays = _scene_arrays(synthetic_scene, rng)
    pts, poses, intr, cams, op, osr, ouv, ow = arrays
    keep = osr < 5  # drop the 6th camera's observations
    intr_mask = np.zeros((1, 7))
    intr_mask[0, 0] = 1.0
    out = run_bundle_adjustment(
        pts, poses[:5], intr, cams[:5], op[keep], osr[keep], ouv[keep],
        ow[keep], intr_mask, config=BAConfig(max_iterations=15),
    )
    assert out["poses"].shape == (5, 6)
    n_obs = int(keep.sum())
    rms = np.sqrt(2 * out["cost"] / n_obs)
    assert rms < 0.05, rms
