"""View-sharded dense stereo vs the sequential per-view loop."""

import numpy as np
import jax.numpy as jnp
import pytest

from sfm_mvs_pipeline.mvs.plane_sweep import (
    make_depth_planes,
    sweep_cost_volume,
    wta_depth,
)
from sfm_mvs_pipeline.parallel.mesh import make_mesh
from sfm_mvs_pipeline.parallel.mvs import (
    compute_depth_maps_sharded,
    fixed_neighbor_table,
)


def _camera_ring(rng, n_views=4, h=48, w=64, f=60.0):
    """Textured fronto-parallel plane at depth ~5 seen from a small ring."""
    tex = rng.random((256, 256)).astype(np.float32)
    poses = np.zeros((n_views, 6), np.float32)
    grays = np.zeros((n_views, h, w), np.float32)
    for v in range(n_views):
        poses[v, 3] = 0.25 * v  # translate along x
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        # plane z=5: backproject pixel -> world -> texture lookup
        X = (xs - w / 2) / f * 5.0 - poses[v, 3]
        Y = (ys - h / 2) / f * 5.0
        u = ((X * 24) % 256).astype(int)
        vv = ((Y * 24) % 256).astype(int)
        grays[v] = tex[vv, u]
    intr = np.array([f, w / 2, h / 2, 0, 0, 0, 0], np.float32)
    return grays, poses, intr


def test_sharded_depth_matches_sequential(rng):
    grays, poses, intr = _camera_ring(rng)
    V = len(grays)
    planes = np.stack(
        [np.asarray(make_depth_planes(3.0, 8.0, 16), np.float32)] * V
    )
    neighbors = {v: [u for u in range(V) if u != v][:3] for v in range(V)}
    nbr_idx, nbr_valid = fixed_neighbor_table(neighbors, list(range(V)), 3)

    mesh = make_mesh()
    depth_sh, valid_sh = compute_depth_maps_sharded(
        mesh, grays, poses, intr, nbr_idx, nbr_valid, planes,
        window_radius=2, max_cost=0.5,
    )

    # sequential oracle: same masked sweep per view, no mesh
    for v in range(V):
        cv = sweep_cost_volume(
            jnp.asarray(grays[v]), jnp.asarray(grays[nbr_idx[v]]),
            jnp.asarray(poses[v]), jnp.asarray(poses[nbr_idx[v]]),
            jnp.asarray(intr), jnp.asarray(planes[v]),
            window_radius=2, nbr_valid=jnp.asarray(nbr_valid[v]),
        )
        d, _, val = wta_depth(cv, jnp.asarray(planes[v]), 0.5)
        np.testing.assert_allclose(depth_sh[v], np.asarray(d), atol=1e-5)
        np.testing.assert_array_equal(valid_sh[v], np.asarray(val))

    # and the depths are sane: plane at z=5 recovered where valid
    got = depth_sh[valid_sh]
    assert len(got) > 0.3 * valid_sh.size / V
    assert abs(np.median(got) - 5.0) < 0.5


def test_masked_sweep_equals_unmasked_when_full(rng):
    grays, poses, intr = _camera_ring(rng, n_views=3)
    planes = np.asarray(make_depth_planes(3.0, 8.0, 8), np.float32)
    nbrs = np.array([1, 2])
    cv_unmasked = sweep_cost_volume(
        jnp.asarray(grays[0]), jnp.asarray(grays[nbrs]),
        jnp.asarray(poses[0]), jnp.asarray(poses[nbrs]),
        jnp.asarray(intr), jnp.asarray(planes), window_radius=2,
    )
    cv_masked = sweep_cost_volume(
        jnp.asarray(grays[0]), jnp.asarray(grays[nbrs]),
        jnp.asarray(poses[0]), jnp.asarray(poses[nbrs]),
        jnp.asarray(intr), jnp.asarray(planes), window_radius=2,
        nbr_valid=jnp.ones(2, bool),
    )
    np.testing.assert_allclose(
        np.asarray(cv_masked), np.asarray(cv_unmasked), atol=1e-6
    )


def test_masked_sweep_ignores_padded_neighbor(rng):
    grays, poses, intr = _camera_ring(rng, n_views=3)
    planes = np.asarray(make_depth_planes(3.0, 8.0, 8), np.float32)
    # one real neighbor + one garbage padded slot
    nbrs = np.array([1, 1])
    garbage = np.stack([grays[1], rng.random(grays[0].shape).astype(np.float32)])
    cv_pad = sweep_cost_volume(
        jnp.asarray(grays[0]), jnp.asarray(garbage),
        jnp.asarray(poses[0]), jnp.asarray(poses[nbrs]),
        jnp.asarray(intr), jnp.asarray(planes), window_radius=2,
        nbr_valid=jnp.asarray([True, False]),
    )
    cv_ref = sweep_cost_volume(
        jnp.asarray(grays[0]), jnp.asarray(grays[1][None]),
        jnp.asarray(poses[0]), jnp.asarray(poses[1][None]),
        jnp.asarray(intr), jnp.asarray(planes), window_radius=2,
        nbr_valid=jnp.ones(1, bool),
    )
    np.testing.assert_allclose(np.asarray(cv_pad), np.asarray(cv_ref), atol=1e-6)


def test_sharded_patchmatch(rng):
    """method="patchmatch" through the sharded path recovers the z=5 plane
    and honors neighbor masks (padded views must not change results)."""
    grays, poses, intr = _camera_ring(rng)
    V = len(grays)
    planes = np.stack(
        [np.asarray(make_depth_planes(3.0, 8.0, 16), np.float32)] * V
    )
    neighbors = {v: [u for u in range(V) if u != v][:3] for v in range(V)}
    nbr_idx, nbr_valid = fixed_neighbor_table(neighbors, list(range(V)), 3)

    mesh = make_mesh()
    depth_sh, valid_sh = compute_depth_maps_sharded(
        mesh, grays, poses, intr, nbr_idx, nbr_valid, planes,
        window_radius=2, max_cost=0.5, method="patchmatch", pm_iterations=5,
    )
    assert valid_sh.any()
    got = depth_sh[valid_sh]
    assert abs(np.median(got) - 5.0) < 0.5
    # continuous depths (not the 16-plane ladder)
    assert len(np.unique(got)) > 100


def test_sharded_rect_matches_sequential(rng):
    """method="rect" (the gather-free default engine) through the sharded
    path equals the sequential per-view calls and recovers the z=5 plane."""
    from sfm_mvs_pipeline.mvs.rectified import rectified_depth

    grays, poses, intr = _camera_ring(rng)
    V = len(grays)
    planes = np.stack(
        [np.asarray(make_depth_planes(3.0, 8.0, 16), np.float32)] * V
    )
    neighbors = {v: [u for u in range(V) if u != v][:3] for v in range(V)}
    nbr_idx, nbr_valid = fixed_neighbor_table(neighbors, list(range(V)), 3)

    mesh = make_mesh()
    depth_sh, valid_sh = compute_depth_maps_sharded(
        mesh, grays, poses, intr, nbr_idx, nbr_valid, planes,
        window_radius=2, max_cost=0.5, method="rect",
    )
    assert valid_sh.any()
    got = depth_sh[valid_sh]
    assert abs(np.median(got) - 5.0) < 0.5

    for v in range(V):
        d, _, val = rectified_depth(
            jnp.asarray(grays[v]), jnp.asarray(grays[nbr_idx[v]]),
            jnp.asarray(poses[v]), jnp.asarray(poses[nbr_idx[v]]),
            jnp.asarray(intr), jnp.float32(planes[v].min()),
            jnp.float32(planes[v].max()), n_levels=16,
            window_radius=2, max_cost=0.5,
            nbr_valid=jnp.asarray(nbr_valid[v]),
        )
        np.testing.assert_allclose(depth_sh[v], np.asarray(d), atol=1e-4)
        np.testing.assert_array_equal(valid_sh[v], np.asarray(val))
