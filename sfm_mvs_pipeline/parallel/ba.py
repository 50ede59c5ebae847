"""Distributed bundle adjustment: points sharded, camera system all-reduced.

The multi-chip DENSE_SCHUR replacement promised in SURVEY.md §2.7 item (3):
  * observations are grouped by point and points are partitioned into
    contiguous shards balanced by observation count (host-side)
  * each chip assembles its shard's point blocks + Schur correction with the
    SAME core as single-chip BA (sfm/ba.py ba_build_core) inside shard_map
  * the (D, D) reduced camera Hessian / rhs / cost are psum'd over ICI
  * the tiny reduced solve happens once on the host; the point
    back-substitution runs shard-locally

Scaling shape: per-chip work ~ O(O_shard) Jacobians + O(P_shard * L^2 * D)
Schur flops; communication = one psum of (D^2 + D + 1) floats per LM
iteration — tiny next to compute, so efficiency stays high as chips grow.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from sfm_mvs_pipeline.parallel.mesh import DATA_AXIS
from sfm_mvs_pipeline.sfm.ba import (
    DENSE_GRID_MAX_SLOTS,
    BAConfig,
    ba_backsub_points,
    ba_build_core,
    ba_lm_dense_core,
    build_shot_table,
    build_track_table,
    compute_residuals,
    pack_dense_obs,
)


def shard_scene_by_points(
    n_dev: int,
    points: np.ndarray,
    obs_point: np.ndarray,
    obs_shot: np.ndarray,
    obs_uv: np.ndarray,
    obs_w: np.ndarray,
    n_shots: int | None = None,
):
    """Partition points into n_dev contiguous shards balanced by obs count.

    Returns dict of stacked per-shard arrays:
      points (n_dev, P_loc, 3), obs_* (n_dev, O_loc, ...), track tables
      (n_dev, P_loc, L) with LOCAL obs indices, and the permutation info
      needed to scatter results back (point_ids (n_dev, P_loc)).
    """
    n_pts = len(points)
    order = np.argsort(obs_point, kind="stable")
    counts = np.bincount(obs_point[(obs_w > 0)], minlength=n_pts)

    # balanced contiguous split of point ids by cumulative obs count
    cum = np.cumsum(counts)
    total = cum[-1] if len(cum) else 0
    bounds = [0]
    for d in range(1, n_dev):
        bounds.append(int(np.searchsorted(cum, total * d / n_dev)))
    bounds.append(n_pts)

    P_loc = max(bounds[d + 1] - bounds[d] for d in range(n_dev))
    P_loc = max(P_loc, 1)

    shards = {
        "points": np.zeros((n_dev, P_loc, 3), points.dtype),
        "point_ids": np.full((n_dev, P_loc), -1, np.int64),
    }
    obs_by_shard = []
    for d in range(n_dev):
        lo, hi = bounds[d], bounds[d + 1]
        pids = np.arange(lo, hi)
        shards["points"][d, : hi - lo] = points[pids]
        shards["point_ids"][d, : hi - lo] = pids
        sel = order[(obs_point[order] >= lo) & (obs_point[order] < hi)]
        obs_by_shard.append(sel)
    O_loc = max(max(len(s) for s in obs_by_shard), 1)

    op = np.zeros((n_dev, O_loc), np.int32)
    osr = np.zeros((n_dev, O_loc), np.int32)
    ouv = np.zeros((n_dev, O_loc, 2), obs_uv.dtype)
    ow = np.zeros((n_dev, O_loc), obs_w.dtype)
    for d in range(n_dev):
        sel = obs_by_shard[d]
        n = len(sel)
        op[d, :n] = obs_point[sel] - bounds[d]  # local point index
        osr[d, :n] = obs_shot[sel]
        ouv[d, :n] = obs_uv[sel]
        ow[d, :n] = obs_w[sel]

    # local tables (indices into the local obs arrays), fastest first:
    # dense (P_loc, S) visibility grids (gather-free build) when every shard
    # is duplicate-free and the grid is small enough; (P_loc, S) shot tables;
    # (P_loc, L) track tables as the general fallback
    table_kind = "track"
    if n_shots is not None and n_dev * P_loc * n_shots <= DENSE_GRID_MAX_SLOTS:
        packs = [
            pack_dense_obs(op[d], osr[d], ouv[d], ow[d], P_loc, n_shots)
            for d in range(n_dev)
        ]
        if all(p is not None for p in packs):
            shards.update(
                {
                    "obs_point": op, "obs_shot": osr, "obs_uv": ouv,
                    "obs_w": ow,
                    "uv_ps": np.stack([p[0] for p in packs]),
                    "w_ps": np.stack([p[1] for p in packs]),
                    "table_kind": "dense",
                }
            )
            return shards
    if n_shots is not None:
        stabs = [
            build_shot_table(op[d], osr[d], ow[d], P_loc, n_shots)
            for d in range(n_dev)
        ]
        if all(t is not None for t in stabs):
            table_kind = "shot"
            tab = np.stack(stabs)
    if table_kind == "track":
        L = 4
        tabs = []
        for d in range(n_dev):
            t = build_track_table(op[d], ow[d], P_loc)
            tabs.append(t)
            L = max(L, t.shape[1])
        tab = np.full((n_dev, P_loc, L), -1, np.int32)
        for d in range(n_dev):
            tab[d, :, : tabs[d].shape[1]] = tabs[d]

    shards.update(
        {
            "obs_point": op, "obs_shot": osr, "obs_uv": ouv, "obs_w": ow,
            "track_tab": tab, "table_kind": table_kind,
        }
    )
    return shards


@functools.lru_cache(maxsize=16)
def _sharded_dense_lm(
    mesh, ftol, lam0, lam_up, lam_down, min_lam, max_lam,
    max_iterations, n_shots, n_cams,
):
    """Build (once per parameter set) the jitted fused distributed LM.

    Rebuilding the shard_map + jit wrapper per call retraces and looks the
    program up in the compile cache again; the lru cache bounds that to the
    first call."""
    spec_shard = P(DATA_AXIS)
    spec_rep = P()

    @functools.partial(jax.jit, static_argnames=())
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            spec_shard, spec_shard, spec_shard,
            spec_rep, spec_rep, spec_rep, spec_rep, spec_rep,
        ),
        out_specs=(
            spec_shard, spec_shard, spec_shard, spec_shard, spec_shard,
            spec_shard,
        ),
    )
    def lm_all(pts_l, uv_l, w_l, pos_, K_, cams_, imask_, pfree_):
        out = ba_lm_dense_core(
            pts_l[0], pos_, K_, cams_, uv_l[0], w_l[0], imask_, pfree_,
            ftol, lam0, lam_up, lam_down, min_lam, max_lam,
            n_shots=n_shots, n_cams=n_cams,
            max_iterations=max_iterations, axis_name=DATA_AXIS,
        )
        pts_o, pos_o, K_o, cost_o, it_o, conv_o = out
        # everything in the fused carry is axis-varying; return all leaves
        # with a leading shard dim and let the host read replica 0
        return (
            pts_o[None], pos_o[None], K_o[None],
            cost_o[None], it_o[None], conv_o[None],
        )

    return lm_all


def _run_sharded_dense(
    mesh, sh, points, poses, intr, cam_of_shot, intr_mask, pose_free,
    cfg, n_dev, n_shots, n_cams,
):
    """Fused distributed LM: the ENTIRE optimization is one shard_map
    program — per-shard gather-free dense Schur assembly, psum of the
    (D, D) camera system over the mesh axis, replicated equilibrated
    Cholesky, shard-local back-substitution, on-device accept/reject loop.
    Zero host round trips per iteration (the table-based path below pays
    ~3 host fetches per iteration)."""
    dt = jax.dtypes.canonicalize_dtype(points.dtype)
    dev = lambda x: jnp.asarray(x, dt)
    pos = dev(poses)
    K = dev(intr)
    cams = jnp.asarray(cam_of_shot, jnp.int32)
    imask = dev(intr_mask)
    pfree = dev(
        pose_free if pose_free is not None else np.ones(n_shots, dtype=dt)
    )
    pts_s = dev(sh["points"])
    uv_s = dev(sh["uv_ps"])
    w_s = dev(sh["w_ps"])

    lm_all = _sharded_dense_lm(
        mesh, cfg.function_tolerance, cfg.init_lambda, cfg.lambda_up,
        cfg.lambda_down, cfg.min_lambda, cfg.max_lambda,
        cfg.max_iterations, n_shots, n_cams,
    )
    pts_o, pos_o, K_o, cost_o, it_o, conv_o = lm_all(
        pts_s, uv_s, w_s, pos, K, cams, imask, pfree
    )

    out_points = np.array(points, copy=True)
    pts_host = np.asarray(pts_o)
    ids = sh["point_ids"]
    for d in range(n_dev):
        valid = ids[d] >= 0
        out_points[ids[d][valid]] = pts_host[d][valid]
    return {
        "points": out_points,
        "poses": np.array(pos_o[0], dtype=poses.dtype),
        "intrinsics": np.array(K_o[0], dtype=intr.dtype),
        "cost": float(np.asarray(cost_o)[0]),
        "iterations": int(np.asarray(it_o)[0]),
        "converged": bool(np.asarray(conv_o)[0]),
    }


def run_bundle_adjustment_sharded(
    mesh,
    points: np.ndarray,
    poses: np.ndarray,
    intr: np.ndarray,
    cam_of_shot: np.ndarray,
    obs_point: np.ndarray,
    obs_shot: np.ndarray,
    obs_uv: np.ndarray,
    obs_w: np.ndarray,
    intr_mask: np.ndarray,
    pose_free: np.ndarray | None = None,
    config: BAConfig | None = None,
) -> dict:
    """Distributed LM bundle adjustment over a 1-D device mesh."""
    from sfm_mvs_pipeline.sfm.ba import _shot_bucket

    cfg = config or BAConfig()
    n_dev = mesh.devices.size
    S_real = poses.shape[0]
    n_cams = intr.shape[0]
    # canonical device dtype: f64 inputs run as f32 on device (x64 disabled),
    # so request the canonical dtype up front instead of warning-truncating
    dt = jax.dtypes.canonicalize_dtype(points.dtype)

    # bucket the static shot axis (same rationale as the single-chip driver:
    # the incremental loop must not recompile the fused program per view)
    n_shots = _shot_bucket(S_real)
    if n_shots > S_real:
        poses = np.concatenate(
            [poses, np.zeros((n_shots - S_real, 6), poses.dtype)]
        )
        cam_of_shot = np.concatenate(
            [cam_of_shot, np.zeros(n_shots - S_real, cam_of_shot.dtype)]
        )
        pf = (
            pose_free
            if pose_free is not None
            else np.ones(S_real, dtype=np.float64)
        )
        pose_free = np.concatenate(
            [pf, np.zeros(n_shots - S_real, np.float64)]
        )

    sh = shard_scene_by_points(
        n_dev, points, obs_point, obs_shot, obs_uv, obs_w, n_shots=n_shots
    )
    P_loc = sh["points"].shape[1]
    table_kind = sh["table_kind"]

    if table_kind == "dense":
        out = _run_sharded_dense(
            mesh, sh, points, poses, intr, cam_of_shot, intr_mask,
            pose_free, cfg, n_dev, n_shots, n_cams,
        )
        out["poses"] = out["poses"][:S_real]
        return out

    dev = lambda x: jnp.asarray(x)
    pos = dev(poses)
    K = dev(intr)
    cams = jnp.asarray(cam_of_shot, jnp.int32)
    imask = dev(intr_mask)
    pfree = dev(
        pose_free if pose_free is not None else np.ones(n_shots, dtype=dt)
    )

    spec_shard = P(DATA_AXIS)
    spec_rep = P()

    @functools.partial(jax.jit, static_argnames=())
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            spec_shard, spec_shard, spec_shard, spec_shard, spec_shard,
            spec_shard, spec_rep, spec_rep, spec_rep, spec_rep, spec_rep,
            spec_rep,
        ),
        out_specs=(
            spec_rep, spec_rep, spec_shard, spec_shard, spec_rep,
            spec_shard, spec_shard,
        ),
    )
    def build(pts_s, op_s, os_s, ouv_s, ow_s, tab_s, pos_, K_, cams_, imask_, pfree_, lam_):
        out = ba_build_core(
            pts_s[0], pos_, K_, cams_, op_s[0], os_s[0], ouv_s[0], ow_s[0],
            tab_s[0], lam_, imask_, pfree_,
            n_shots=n_shots, n_cams=n_cams, axis_name=DATA_AXIS,
            table_kind=table_kind,
        )
        S_red, rhs, Bp, gp, cost, Wc, Wi = out
        return S_red, rhs, Bp[None], gp[None], cost, Wc[None], Wi[None]

    @functools.partial(jax.jit, static_argnames=())
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            spec_rep, spec_shard, spec_shard, spec_shard, spec_shard,
            spec_shard, spec_shard, spec_shard, spec_rep,
        ),
        out_specs=(spec_shard, spec_rep, spec_rep),
    )
    def backsub(dcam_, Bp_s, gp_s, Wc_s, Wi_s, tab_s, os_sh, oc_sh, cams_):
        dX, dpose, dintr = ba_backsub_points(
            dcam_, Bp_s[0], gp_s[0], Wc_s[0], Wi_s[0], tab_s[0],
            os_sh[0], cams_ if table_kind == "shot" else oc_sh[0],
            n_shots=n_shots, n_cams=n_cams, table_kind=table_kind,
        )
        return dX[None], dpose, dintr

    # device-resident shard arrays
    pts_s = dev(sh["points"])
    op_s = jnp.asarray(sh["obs_point"])
    os_s = jnp.asarray(sh["obs_shot"])
    ouv_s = dev(sh["obs_uv"])
    ow_s = dev(sh["obs_w"])
    tab_s = jnp.asarray(sh["track_tab"])
    oc_s = cams[os_s]  # per-obs camera index, sharded like obs

    _, cost0 = compute_residuals(
        pts_s.reshape(-1, 3), pos, K, cams,
        (op_s + jnp.arange(n_dev)[:, None] * P_loc).reshape(-1),
        os_s.reshape(-1), ouv_s.reshape(-1, 2), ow_s.reshape(-1),
    )
    cost = float(cost0)
    lam = cfg.init_lambda
    iters = 0
    converged = False

    for it in range(cfg.max_iterations):
        iters = it + 1
        S_red, rhs, Bp, gp, _, Wc, Wi = build(
            pts_s, op_s, os_s, ouv_s, ow_s, tab_s, pos, K, cams, imask,
            pfree, jnp.asarray(lam, dtype=dt),
        )
        S_np = np.array(S_red, np.float64)
        rhs_np = np.array(rhs, np.float64)
        dead = np.abs(np.diag(S_np)) < 1e-12
        S_np[dead, :] = 0.0
        S_np[:, dead] = 0.0
        S_np[dead, dead] = 1.0
        rhs_np[dead] = 0.0
        try:
            dcam = np.linalg.solve(S_np, rhs_np)
        except np.linalg.LinAlgError:
            dcam = np.linalg.lstsq(S_np, rhs_np, rcond=None)[0]

        dX, dpose, dintr = backsub(
            jnp.asarray(dcam, dt), Bp, gp, Wc, Wi, tab_s, os_s, oc_s, cams
        )
        new_pts = pts_s + dX
        new_pos = pos + dpose * pfree[:, None]
        new_K = K + dintr * imask
        _, nc = compute_residuals(
            new_pts.reshape(-1, 3), new_pos, new_K, cams,
            (op_s + jnp.arange(n_dev)[:, None] * P_loc).reshape(-1),
            os_s.reshape(-1), ouv_s.reshape(-1, 2), ow_s.reshape(-1),
        )
        nc = float(nc)
        if np.isfinite(nc) and nc < cost:
            rel = (cost - nc) / max(cost, 1e-30)
            pts_s, pos, K = new_pts, new_pos, new_K
            cost = nc
            lam = max(lam * cfg.lambda_down, cfg.min_lambda)
            if rel < cfg.function_tolerance:
                converged = True
                break
        else:
            lam *= cfg.lambda_up
            if lam > cfg.max_lambda:
                break

    # scatter shard points back to global order
    out_points = np.array(points, copy=True)
    pts_host = np.asarray(pts_s)
    ids = sh["point_ids"]
    for d in range(n_dev):
        valid = ids[d] >= 0
        out_points[ids[d][valid]] = pts_host[d][valid]

    return {
        "points": out_points,
        "poses": np.array(pos, dtype=poses.dtype)[:S_real],
        "intrinsics": np.array(K, dtype=intr.dtype),
        "cost": cost,
        "iterations": iters,
        "converged": converged,
    }
