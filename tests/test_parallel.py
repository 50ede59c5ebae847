"""Multi-device tests on the simulated 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp

from sfm_mvs_pipeline.parallel.mesh import make_mesh
from sfm_mvs_pipeline.parallel.matching import match_pairs_sharded
from sfm_mvs_pipeline.parallel.ba import (
    run_bundle_adjustment_sharded,
    shard_scene_by_points,
)
from sfm_mvs_pipeline.ops.matching import match_pairs_batch
from sfm_mvs_pipeline.ops.pairs import unordered_pairs
from sfm_mvs_pipeline.sfm.ba import BAConfig, run_bundle_adjustment


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_sharded_matching_equals_single(rng):
    S, F, D = 6, 128, 32
    descs = np.abs(rng.normal(size=(S, F, D))).astype(np.float32)
    valid = np.ones((S, F), bool)
    pairs = unordered_pairs(S)  # 15 pairs over 8 devices

    mesh = make_mesh()
    idx_s, mask_s = match_pairs_sharded(
        mesh, descs, valid, pairs
    )
    idx_1, mask_1 = match_pairs_batch(
        jnp.asarray(descs), jnp.asarray(valid), jnp.asarray(pairs)
    )
    np.testing.assert_array_equal(mask_s, np.asarray(mask_1))
    np.testing.assert_array_equal(
        idx_s[mask_s], np.asarray(idx_1)[np.asarray(mask_1)]
    )


def _ba_problem(rng, S=8, P=2000):
    f = 500.0
    pts = rng.uniform(-3, 3, size=(P, 3))
    pts[:, 2] += 10
    poses = np.zeros((S, 6))
    obs_p, obs_s, obs_uv = [], [], []
    for s in range(S):
        ang = (s - S / 2) * 0.08
        poses[s] = [0, ang, 0, -2 * np.sin(ang), 0.02 * s, 10 - 10 * np.cos(ang)]
        R = np.array(
            [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]]
        )
        pc = pts @ R.T + poses[s][3:]
        uv = pc[:, :2] / pc[:, 2:3] * f + [320, 240]
        sel = rng.random(P) < 0.7
        obs_p.append(np.nonzero(sel)[0])
        obs_s.append(np.full(sel.sum(), s))
        obs_uv.append(uv[sel] + rng.normal(size=(sel.sum(), 2)) * 0.3)
    obs_p = np.concatenate(obs_p).astype(np.int32)
    obs_s = np.concatenate(obs_s).astype(np.int32)
    obs_uv = np.concatenate(obs_uv)
    intr = np.array([[f, 320, 240, 0, 0, 0, 0]])
    pts_noisy = pts + rng.normal(size=pts.shape) * 0.03
    return pts_noisy, poses, intr, obs_p, obs_s, obs_uv


def test_shard_scene_by_points(rng):
    pts, poses, intr, op, osr, ouv = _ba_problem(rng)
    sh = shard_scene_by_points(4, pts, op, osr, ouv, np.ones(len(op)))
    # every live observation lands in exactly one shard with a local index
    total = sum(int((sh["obs_w"][d] > 0).sum()) for d in range(4))
    assert total == len(op)
    for d in range(4):
        live = sh["obs_w"][d] > 0
        lp = sh["obs_point"][d][live]
        gids = sh["point_ids"][d][lp]
        assert (gids >= 0).all()
        # local obs uv must match the global table for the mapped points
        assert set(map(tuple, sh["obs_uv"][d][live])) <= set(map(tuple, ouv))


def test_sharded_ba_matches_single_chip(rng):
    pts, poses, intr, op, osr, ouv = _ba_problem(rng)
    ow = np.ones(len(op))
    imask = np.zeros((1, 7))
    imask[0, 0] = 1.0
    cfg = BAConfig(max_iterations=10)

    single = run_bundle_adjustment(
        pts.copy(), poses.copy(), intr.copy(), np.zeros(len(poses), np.int32),
        op, osr, ouv, ow, imask, config=cfg,
    )
    mesh = make_mesh()
    sharded = run_bundle_adjustment_sharded(
        mesh, pts.copy(), poses.copy(), intr.copy(),
        np.zeros(len(poses), np.int32), op, osr, ouv, ow, imask, config=cfg,
    )
    # identical LM trajectory up to fp ordering -> costs agree closely
    assert abs(single["cost"] - sharded["cost"]) / single["cost"] < 1e-3
    np.testing.assert_allclose(
        sharded["poses"], single["poses"], atol=1e-4
    )
    np.testing.assert_allclose(
        sharded["points"], single["points"], atol=1e-2
    )


def test_distributed_single_process_degenerates():
    """Single-process: bring-up is a no-op, host_shard returns everything,
    assemble_global builds a correctly-sharded global array."""
    import jax
    from jax.sharding import PartitionSpec as P, NamedSharding

    from sfm_mvs_pipeline.parallel.distributed import (
        all_hosts_agree,
        assemble_global,
        host_shard,
        initialize_distributed,
        process_count,
        process_index,
    )
    from sfm_mvs_pipeline.parallel.mesh import make_mesh

    assert initialize_distributed() is False
    assert process_count() == 1 and process_index() == 0
    items = list(range(10))
    assert host_shard(items) == items
    assert all_hosts_agree(10)

    mesh = make_mesh(8)
    sh = NamedSharding(mesh, P("data"))
    arr = assemble_global(mesh, sh, np.arange(16, dtype=np.float32).reshape(8, 2))
    assert arr.shape == (8, 2)
    assert len(arr.addressable_shards) == 8
