"""Per-view-sharded dense stereo: depth maps data-parallel over the mesh.

SURVEY.md §2.7 item (4): each chip owns a slice of the reference views and
computes their plane-sweep (optionally SGM-aggregated) depth maps; fusion
afterwards is a host-side reduce over the gathered maps. This replaces the
reference's per-view OpenMP threading inside openMVS
(ref: src/photogrammetrie/mvs/MVS.cpp:29 — openMVS::Scene constructed with
omp_get_max_threads() workers).

Design notes
------------
* Every view must present identical shapes under shard_map, so neighbor
  lists are fixed-capacity (N slots + validity mask — handled inside
  sweep_cost_volume) and every view gets the same plane count with its own
  per-view depth ladder.
* Images are replicated across the mesh (each chip needs its views'
  neighbor images; at MVS resolutions V*H*W is comfortably HBM-resident).
  The view axis — ids, neighbor tables, plane ladders — is sharded.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from sfm_mvs_pipeline.parallel.mesh import DATA_AXIS


def compute_depth_maps_sharded(
    mesh,
    grays: np.ndarray,  # (V, H, W) f32 undistorted grayscale
    poses: np.ndarray,  # (V, 6)
    intr: np.ndarray,  # (7,) pinhole (distortion zeroed)
    nbr_idx: np.ndarray,  # (V, N) int32 neighbor view indices (pad 0)
    nbr_valid: np.ndarray,  # (V, N) bool
    planes: np.ndarray,  # (V, D) per-view depth ladders
    window_radius: int = 3,
    use_sgm: bool = False,
    sgm_p1: float = 0.03,
    sgm_p2: float = 0.3,
    max_cost: float = 0.35,
    method: str = "sweep",
    pm_iterations: int = 8,
    pm_seed_rect: bool = True,
    max_disp: int = 256,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (depth (V, H, W) f32, valid (V, H, W) bool).

    method="patchmatch" runs the checkerboard PatchMatch (mvs/patchmatch.py)
    per view instead of the plane sweep; the per-view plane ladder then only
    supplies the depth search range (its min/max)."""
    from sfm_mvs_pipeline.mvs.plane_sweep import sweep_cost_volume, wta_depth

    V, H, W = grays.shape
    n_dev = mesh.devices.size
    V_pad = ((V + n_dev - 1) // n_dev) * n_dev

    def padv(x, fill=0):
        if V_pad == len(x):
            return x
        widths = [(0, V_pad - len(x))] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, widths, constant_values=fill)

    view_ids = padv(np.arange(V, dtype=np.int32))
    nbr_idx_p = padv(np.asarray(nbr_idx, np.int32))
    nbr_valid_p = padv(np.asarray(nbr_valid, bool), fill=False)
    planes_p = padv(np.asarray(planes, np.float32), fill=1.0)

    dt = jnp.float32
    grays_d = jnp.asarray(grays, dt)
    poses_d = jnp.asarray(poses, dt)
    intr_d = jnp.asarray(intr, dt)

    spec_v = P(DATA_AXIS)
    spec_r = P()

    @functools.partial(jax.jit, static_argnames=())
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(spec_v, spec_v, spec_v, spec_v, spec_r, spec_r, spec_r),
        out_specs=(spec_v, spec_v),
    )
    def work(vids, nidx, nval, pl, grays_, poses_, intr_):
        def one(args):
            vid, nbrs, nv, planes_v = args
            if method == "rect":
                from sfm_mvs_pipeline.mvs.rectified import rectified_depth

                depth, _cost, valid = rectified_depth(
                    grays_[vid], grays_[nbrs], poses_[vid], poses_[nbrs],
                    intr_, jnp.min(planes_v), jnp.max(planes_v),
                    n_levels=planes_v.shape[0],
                    window_radius=window_radius, max_cost=max_cost,
                    max_disp=max_disp, nbr_valid=nv,
                    use_sgm=use_sgm, sgm_p1=sgm_p1, sgm_p2=sgm_p2,
                )
                any_nbr = jnp.any(nv)
                return jnp.where(any_nbr, depth, 0.0), valid & any_nbr
            if method == "patchmatch" and not use_sgm:
                from sfm_mvs_pipeline.mvs.patchmatch import patchmatch_depth
                from sfm_mvs_pipeline.mvs.rectified import rectified_depth

                seed_d = seed_v = None
                pm_iters = pm_iterations
                if pm_seed_rect:
                    # same rect-seeded schedule as the sequential path
                    seed_d, _sc, seed_v = rectified_depth(
                        grays_[vid], grays_[nbrs], poses_[vid], poses_[nbrs],
                        intr_, jnp.min(planes_v), jnp.max(planes_v),
                        n_levels=planes_v.shape[0],
                        window_radius=window_radius, max_cost=max_cost,
                        max_disp=max_disp, nbr_valid=nv,
                    )
                    pm_iters = max(2, pm_iterations // 4)
                depth, _cost, valid = patchmatch_depth(
                    grays_[vid], grays_[nbrs], poses_[vid], poses_[nbrs],
                    intr_, jnp.min(planes_v), jnp.max(planes_v),
                    jax.random.fold_in(jax.random.PRNGKey(0), vid),
                    init_depth=seed_d, init_valid=seed_v,
                    iterations=pm_iters,
                    window_radius=window_radius, max_cost=max_cost,
                    nbr_valid=nv,
                )
                any_nbr = jnp.any(nv)
                return jnp.where(any_nbr, depth, 0.0), valid & any_nbr
            cv = sweep_cost_volume(
                grays_[vid], grays_[nbrs], poses_[vid], poses_[nbrs],
                intr_, planes_v, window_radius=window_radius, nbr_valid=nv,
            )
            if use_sgm:
                from sfm_mvs_pipeline.mvs.sgm import sgm_aggregate

                cv = sgm_aggregate(cv, sgm_p1, sgm_p2)
            depth, _cost, valid = wta_depth(cv, planes_v, max_cost)
            any_nbr = jnp.any(nv)
            return (
                jnp.where(any_nbr, depth, 0.0),
                valid & any_nbr,
            )

        return jax.lax.map(one, (vids, nidx, nval, pl))

    depth, valid = work(
        jnp.asarray(view_ids), jnp.asarray(nbr_idx_p),
        jnp.asarray(nbr_valid_p), jnp.asarray(planes_p),
        grays_d, poses_d, intr_d,
    )
    return np.asarray(depth)[:V], np.asarray(valid)[:V]


def fixed_neighbor_table(
    neighbors: dict, rec: list, capacity: int
) -> tuple[np.ndarray, np.ndarray]:
    """Fixed-capacity neighbor table over LOCAL view indices.

    neighbors: {shot_id: [shot_id, ...]} from mvs.neighbors.select_neighbors;
    rec: recovered shot ids in local order. Returns (idx (V, N), valid (V, N)).
    """
    idx_of = {s: i for i, s in enumerate(rec)}
    V = len(rec)
    idx = np.zeros((V, capacity), np.int32)
    valid = np.zeros((V, capacity), bool)
    for i, s in enumerate(rec):
        loc = [idx_of[n] for n in neighbors.get(s, []) if n in idx_of][:capacity]
        idx[i, : len(loc)] = loc
        valid[i, : len(loc)] = True
    return idx, valid
