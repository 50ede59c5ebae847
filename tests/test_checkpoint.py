"""Scene checkpoint round trip + matcher method selection."""

import numpy as np
import jax.numpy as jnp

from sfm_mvs_pipeline.models.scene import Scene
from sfm_mvs_pipeline.utils.checkpoint import load_scene, save_scene
from sfm_mvs_pipeline.ops import matching as M


def test_scene_checkpoint_roundtrip(tmp_path, rng):
    S, F, D = 3, 32, 16
    scene = Scene.create(
        ["a.jpg", "b.jpg", "c.jpg"],
        (640, 480),
        rng.normal(size=(S, F, 2)),
        rng.normal(size=(S, F, D)),
        np.ones((S, F), bool),
        np.array([500.0, 320, 240, 0, 0, 0, 0]),
    )
    scene.add_points(
        rng.normal(size=(4, 3)),
        [[(0, i, scene.keypoints[0, i])] for i in range(4)],
    )
    scene.poses[1, 3] = 1.0
    scene.recovered[:2] = True

    p = str(tmp_path / "scene.npz")
    save_scene(scene, p)
    back = load_scene(p)
    assert back.image_paths == scene.image_paths
    assert back.image_size == scene.image_size
    assert back.camera_model == scene.camera_model
    np.testing.assert_array_equal(back.poses, scene.poses)
    np.testing.assert_array_equal(back.points, scene.points)
    np.testing.assert_array_equal(back.obs_point, scene.obs_point)
    np.testing.assert_array_equal(back.point_of_feat, scene.point_of_feat)


def test_flann_method_agrees_with_exact(rng):
    """The approximate matcher must find the same matches on easy data."""
    F, D = 256, 64
    dq = np.abs(rng.normal(size=(F, D))).astype(np.float32)
    dt = np.abs(rng.normal(size=(F, D))).astype(np.float32)
    dt[:128] = dq[:128] + rng.normal(size=(128, D)).astype(np.float32) * 0.01
    vq = jnp.ones(F, bool)
    vt = jnp.ones(F, bool)

    bi_e, me = M.match_pair(
        jnp.asarray(dq), jnp.asarray(dt), vq, vt, method="bf"
    )
    bi_a, ma = M.match_pair(
        jnp.asarray(dq), jnp.asarray(dt), vq, vt, method="flann"
    )
    me, ma = np.asarray(me), np.asarray(ma)
    # recall of the approximate matcher on the planted easy matches
    planted = np.arange(128)
    exact_hits = me[planted] & (np.asarray(bi_e)[planted] == planted)
    approx_hits = ma[planted] & (np.asarray(bi_a)[planted] == planted)
    assert exact_hits.sum() >= 120
    assert approx_hits.sum() >= 0.95 * exact_hits.sum()
