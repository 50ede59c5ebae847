"""Fused two-view pair program, and PatchMatch on a constant-disparity pair."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest


def test_pairs_fused_matches_sequential(rng):
    """The batched fused pair program (essential -> cheirality ->
    triangulation in one dispatch) must equal the sequential per-pair
    jits given the same RANSAC key."""
    from sfm_mvs_pipeline.sfm.incremental import (
        _pair_pose_jit,
        _pairs_fused_jit,
        _triangulate_pair_jit,
    )

    F = 64
    # synthetic two-view geometry: points in front of both cameras
    X = rng.random((F, 3)) * 4 + np.array([0, 0, 6.0])
    f = 100.0
    intr = jnp.asarray([f, 40.0, 30.0, 0, 0, 0, 0], jnp.float64)
    pose_a = np.zeros(6)
    pose_b = np.zeros(6)
    pose_b[3] = -1.0  # baseline
    from sfm_mvs_pipeline.ops.pose import aa_to_rotmat_np

    def project(pose, X):
        R = aa_to_rotmat_np(pose[:3])
        Xc = X @ R.T + pose[3:]
        return (Xc[:, :2] / Xc[:, 2:]) * f + np.array([40.0, 30.0])

    kp_a = project(pose_a, X)
    kp_b = project(pose_b, X)
    idx = np.arange(F, dtype=np.int32)
    mask = np.ones(F, bool)
    key = jax.random.key(3)

    pose_s, em_s = _pair_pose_jit(
        jnp.asarray(kp_a), jnp.asarray(kp_b), jnp.asarray(idx),
        jnp.asarray(mask), intr, intr, 2.0, key,
    )
    pts_s, keep_s = _triangulate_pair_jit(
        jnp.asarray(pose_a), jnp.asarray(pose_b), intr, intr,
        jnp.asarray(kp_a), jnp.asarray(kp_b), jnp.asarray(idx),
        em_s, 10.0,
    )
    pose_f, em_f, pts_f, keep_f, n_inl = _pairs_fused_jit(
        jnp.asarray(kp_a)[None], jnp.asarray(kp_b)[None],
        jnp.asarray(idx)[None], jnp.asarray(mask)[None],
        intr[None], intr[None],
        jnp.asarray(pose_a)[None], jnp.asarray(pose_b)[None],
        2.0, 10.0, key[None], False,
    )
    np.testing.assert_allclose(
        np.asarray(pose_f[0]), np.asarray(pose_s), atol=1e-6
    )
    np.testing.assert_array_equal(np.asarray(em_f[0]), np.asarray(em_s))
    np.testing.assert_array_equal(np.asarray(keep_f[0]), np.asarray(keep_s))
    np.testing.assert_allclose(
        np.asarray(pts_f[0])[np.asarray(keep_s)],
        np.asarray(pts_s)[np.asarray(keep_s)], atol=1e-5,
    )
    assert int(n_inl[0]) == int(np.asarray(em_s).sum())


def test_patchmatch_depth_recovers_shift(rng):
    """A laterally-shifted constant-disparity pair (the pair of the former
    rectified-frame PatchMatch test): the warp-based PatchMatch must
    recover the fronto-parallel plane's depth."""
    from sfm_mvs_pipeline.mvs.patchmatch import patchmatch_depth

    h, w = 32, 64
    f, b, z = 50.0, 1.0, 5.0
    disp = f * b / z  # 10 px
    tex = rng.random((h, w + 32)).astype(np.float32)
    tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)) / 3.0
    ref = tex[:, 16:16 + w]
    di = int(disp)
    # u_n = u_r - disp  =>  nbr[x] = ref[x + disp]
    nbr = tex[:, 16 + di:16 + di + w]

    pose_r = np.zeros(6, np.float32)
    pose_n = np.zeros(6, np.float32)
    pose_n[3] = -b
    intr = np.asarray([f, w / 2, h / 2, 0, 0, 0, 0], np.float32)

    dep, cost, valid = patchmatch_depth(
        jnp.asarray(ref), jnp.asarray(nbr)[None], jnp.asarray(pose_r),
        jnp.asarray(pose_n)[None], jnp.asarray(intr), 2.0, 12.0,
        jax.random.PRNGKey(0), iterations=6, window_radius=2,
    )
    dep = np.asarray(dep)
    valid = np.array(valid)
    # exclude the left margin: columns x < disp have their true source
    # off-image (the classic stereo left-edge artifact; consensus fusion
    # handles them in the multi-view pipeline)
    valid[:, : di + 3] = False
    assert valid.mean() > 0.4, f"valid frac {valid.mean()}"
    err = np.abs(dep[valid] - z) / z
    assert np.median(err) < 0.05, f"median depth err {np.median(err)}"
