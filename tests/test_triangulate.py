"""Triangulation vs OpenCV oracle and synthetic ground truth."""

import numpy as np
import cv2
import jax.numpy as jnp

from sfm_mvs_pipeline.ops.triangulate import triangulate_dlt, triangulate_pair


def test_dlt_matches_cv_triangulate(synthetic_scene):
    s = synthetic_scene
    (R1, t1), (R2, t2) = s["poses"][0], s["poses"][3]
    P1 = np.hstack([R1, t1.reshape(3, 1)])
    P2 = np.hstack([R2, t2.reshape(3, 1)])
    f, cx, cy = s["intr"][0], s["intr"][1], s["intr"][2]
    xy1 = (s["obs"][0] - [cx, cy]) / f
    xy2 = (s["obs"][3] - [cx, cy]) / f

    ours = np.asarray(
        triangulate_dlt(
            jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(xy1), jnp.asarray(xy2)
        )
    )
    pts4d = cv2.triangulatePoints(P1, P2, xy1.T, xy2.T)
    cv_pts = (pts4d[:3] / pts4d[3]).T
    np.testing.assert_allclose(ours, cv_pts, atol=1e-4)
    np.testing.assert_allclose(ours, s["points"], atol=1e-4)


def test_triangulate_pair_filters(synthetic_scene):
    s = synthetic_scene
    (R1, t1), (R2, t2) = s["poses"][1], s["poses"][4]
    import sfm_mvs_pipeline.ops.pose as P

    pose1 = jnp.concatenate(
        [P.rotmat_to_aa(jnp.asarray(R1)), jnp.asarray(t1)]
    )
    pose2 = jnp.concatenate(
        [P.rotmat_to_aa(jnp.asarray(R2)), jnp.asarray(t2)]
    )
    intr = jnp.asarray(s["intr"])
    uv1 = jnp.asarray(s["obs"][1])
    uv2 = np.array(s["obs"][4])
    uv2[:10] += 80.0  # corrupt 10 observations -> should be filtered
    pts, keep, errs = triangulate_pair(
        pose1, pose2, intr, intr, uv1, jnp.asarray(uv2), max_reprojection_error=10.0
    )
    keep = np.asarray(keep)
    assert keep[10:].all()
    assert not keep[:10].any()
    np.testing.assert_allclose(
        np.asarray(pts)[keep], s["points"][keep], atol=1e-3
    )
