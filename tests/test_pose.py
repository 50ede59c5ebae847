"""Pose algebra vs OpenCV Rodrigues oracle."""

import numpy as np
import cv2
import jax.numpy as jnp

from sfm_mvs_pipeline.ops import pose as P


def test_aa_to_rotmat_matches_cv(rng):
    rvecs = rng.normal(size=(64, 3)) * 2.0
    rvecs[0] = 0.0  # identity
    rvecs[1] = [np.pi, 0, 0]  # near pi
    ours = np.asarray(P.aa_to_rotmat(jnp.asarray(rvecs, dtype=jnp.float64)))
    for i, rv in enumerate(rvecs):
        Rcv, _ = cv2.Rodrigues(rv.reshape(3, 1))
        np.testing.assert_allclose(ours[i], Rcv, atol=1e-6)


def test_rotmat_roundtrip(rng):
    rvecs = rng.normal(size=(64, 3)) * 1.5
    rvecs[0] = 0.0
    rvecs[1] = [0, np.pi - 1e-7, 0]
    R = P.aa_to_rotmat(jnp.asarray(rvecs, dtype=jnp.float64))
    back = P.rotmat_to_aa(R)
    R2 = P.aa_to_rotmat(back)
    # rotation matrices must round-trip even if rvec sign flips at pi
    np.testing.assert_allclose(np.asarray(R2), np.asarray(R), atol=1e-5)


def test_camera_center(rng):
    rv = rng.normal(size=3)
    t = rng.normal(size=3)
    pose = jnp.asarray(np.concatenate([rv, t]), dtype=jnp.float64)
    C = np.asarray(P.camera_center(pose))
    Rcv, _ = cv2.Rodrigues(rv.reshape(3, 1))
    np.testing.assert_allclose(C, -Rcv.T @ t, atol=1e-8)


def test_compose_invert(rng):
    a = jnp.asarray(rng.normal(size=6), dtype=jnp.float64)
    b = jnp.asarray(rng.normal(size=6), dtype=jnp.float64)
    ab = P.compose_pose(a, b)
    x = jnp.asarray(rng.normal(size=3), dtype=jnp.float64)
    lhs = P.transform_points(ab, x)
    rhs = P.transform_points(a, P.transform_points(b, x))
    np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs), atol=1e-8)

    inv = P.invert_pose(a)
    back = P.transform_points(inv, P.transform_points(a, x))
    np.testing.assert_allclose(np.asarray(back), np.asarray(x), atol=1e-8)


def test_relative_pose(rng):
    a = jnp.asarray(rng.normal(size=6), dtype=jnp.float64)
    b = jnp.asarray(rng.normal(size=6), dtype=jnp.float64)
    rel = P.relative_pose(a, b)
    x = jnp.asarray(rng.normal(size=3), dtype=jnp.float64)
    # x_b = rel(x_a)
    xa = P.transform_points(a, x)
    xb = P.transform_points(b, x)
    np.testing.assert_allclose(
        np.asarray(P.transform_points(rel, xa)), np.asarray(xb), atol=1e-7
    )


def test_aa_to_rotmat_np_matches_jax():
    """The host-numpy Rodrigues (used by PLY writers, stats, and dense
    geometry prechecks to avoid per-op device round trips) must match the
    device implementation, including at exactly zero rotation."""
    import numpy as np
    import jax.numpy as jnp

    from sfm_mvs_pipeline.ops.pose import aa_to_rotmat, aa_to_rotmat_np

    rng = np.random.default_rng(3)
    rvecs = np.concatenate(
        [rng.normal(size=(8, 3)), np.zeros((1, 3)), [[np.pi, 0, 0]]]
    )
    for r in rvecs:
        Rj = np.asarray(aa_to_rotmat(jnp.asarray(r, jnp.float64)))
        Rn = aa_to_rotmat_np(r)
        np.testing.assert_allclose(Rn, Rj, atol=1e-6)
