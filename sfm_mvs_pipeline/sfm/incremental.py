"""Incremental SfM driver: the host-side state machine over jitted kernels.

Mirrors SfM::reconstructScene / SfM::triangulate
(ref: src/photogrammetrie/sfm/SfM.cpp:143-381):

  extract features -> match pairs -> homography ratios -> baseline pair ->
  loop: pick best 3D-2D shot -> PnP -> triangulate adjoining pairs ->
  merge into tracks -> bundle adjust -> repeat

The *driver* is Python (the view ordering is inherently sequential and
data-dependent — SURVEY.md §7 hard part (a)); every inner computation is a
fixed-shape jitted batch op: matching (batched 2-NN), homography/essential/
PnP RANSAC, triangulation, LM bundle adjustment. Track bookkeeping uses the
point_of_feat index join (models/scene.py) instead of the reference's
linear scans.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from sfm_mvs_pipeline.models.cameras import CAMERA_MODELS
from sfm_mvs_pipeline.models.scene import Scene
from sfm_mvs_pipeline.ops import matching as M
from sfm_mvs_pipeline.ops.epipolar import (
    find_essential_ransac,
    recover_pose,
    recover_pose_from_homography,
    two_view_model_scores,
)
from sfm_mvs_pipeline.ops.homography import (
    find_homography_ransac,
    homography_inlier_ratio,
)
from sfm_mvs_pipeline.ops.pnp import solve_pnp_ransac
from sfm_mvs_pipeline.ops.pose import compose_pose
from sfm_mvs_pipeline.ops.triangulate import triangulate_pair
from sfm_mvs_pipeline.models.cameras import undistort_points
from sfm_mvs_pipeline.sfm.ba import BAConfig, run_bundle_adjustment


@dataclasses.dataclass
class SfMConfig:
    """Thresholds mirroring the reference defaults (src/photogrammetrie/sfm/SfM.h:47-58)."""

    min_match_count: int = 20
    baseline_min_matches: int = 100
    ransac_matching_threshold: float = -3.0  # sign convention: <0 => abs px
    ransac_baseline_threshold: float = -1.0
    ransac_pose_threshold: float = -8.0
    min_homography_inlier_ratio: float = 0.4  # ref default (PhotogrammetrieCli.cpp:105)
    min_pose_inlier_ratio: float = 0.4  # ref default (PhotogrammetrieCli.cpp:106)
    max_reprojection_error: float = 10.0
    point_merge_distance: float = 0.01
    feature_merge_distance: float = 20.0
    lowe_ratio: float = 0.7
    distinct_matches: bool = False
    matcher_method: str = "bf"  # "flann" = approximate shortlist matcher
    # exact distance mode (-Pmatch-precision=exact): f32 matcher operands
    # at full precision instead of bf16 (see ops/matching.match_pair)
    exact_match: bool = False
    # descriptors are a +-1 binary (ORB/Hamming) expansion: matched as
    # bfloat16, which is EXACT for +-1 values
    binary_descriptors: bool = False
    ba: BAConfig = dataclasses.field(default_factory=BAConfig)
    ba_every_view: bool = True  # reference runs BA after every added view
    seed: int = 0


def _resolve_thresh(param: float, max_dim: float) -> float:
    return -param if param < 0 else param * max_dim


# ------------------------------------------------------------ jitted helpers
def _dual_model_pose(key, xy1, xy2, mask, thresh_norm):
    """Relative pose by E-vs-H model selection.

    The 8-point essential solver is DEGENERATE for coplanar scenes — any
    E = [v]ₓH fits planar correspondences exactly, so neither RANSAC
    support nor triangulated reprojection error can detect the failure
    (the wrong E reconstructs a wrong-but-photoconsistent two-view
    geometry). The reference is immune because cv::findEssentialMat is
    Nistér's 5-point (SfM.cpp:525). Here we recover the robustness
    ORB-SLAM-style: fit BOTH an essential matrix and a calibrated
    homography, score each as an image-to-image model
    (two_view_model_scores), and take the homography's Faugeras
    decomposition when S_H/(S_H+S_E) > 0.45 — the planar / low-parallax
    regime where E earned no advantage.

    Returns (pose_e, em2, pose_h, hm2, use_h)."""
    k_e, k_h = jax.random.split(key)
    E, em, _ = find_essential_ransac(k_e, xy1, xy2, mask, thresh_norm)
    pose_e, em2 = recover_pose(E, xy1, xy2, em)
    H, hm, _ = find_homography_ransac(k_h, xy1, xy2, mask, thresh_norm)
    pose_h, hm2 = recover_pose_from_homography(
        H, xy1, xy2, hm, mask, thresh_norm
    )
    se, sh = two_view_model_scores(E, H, xy1, xy2, mask, thresh_norm)
    use_h = sh / jnp.maximum(sh + se, 1e-18) > 0.45
    return pose_e, em2, pose_h, hm2, use_h


@partial(jax.jit, static_argnames=())
def _pair_pose_jit(kp_a, kp_b, idx, mask, intr_a, intr_b, thresh_px, key):
    """Relative pose of pair via E-vs-H model selection
    (see _dual_model_pose).

    Returns (pose6 rel, inlier_mask (F,))."""
    uv1 = kp_a
    uv2 = kp_b[idx]
    xy1 = undistort_points(intr_a, uv1)
    xy2 = undistort_points(intr_b, uv2)
    f = intr_a[0]
    pose_e, em2, pose_h, hm2, use_h = _dual_model_pose(
        key, xy1, xy2, mask, thresh_px / f
    )
    pose = jnp.where(use_h, pose_h, pose_e)
    return pose, jnp.where(use_h, hm2, em2)


@partial(jax.jit, static_argnames=())
def _triangulate_pair_jit(
    pose_a, pose_b, intr_a, intr_b, kp_a, kp_b, idx, mask, max_err
):
    uv1 = kp_a
    uv2 = kp_b[idx]
    pts, keep, errs = triangulate_pair(
        pose_a, pose_b, intr_a, intr_b, uv1, uv2,
        valid=mask, max_reprojection_error=max_err,
    )
    return pts, keep


@partial(jax.jit, static_argnames=("use_rel",))
def _pairs_fused_jit(
    kp_a, kp_b, idx, mask, intr_a, intr_b, pose_a, pose_b,
    thresh_px, max_err, keys, use_rel: bool,
):
    """P pairs in ONE dispatch: essential RANSAC -> cheirality pose ->
    triangulation: batching makes the whole baseline scan /
    adjoining-pair set one dispatch and one round trip instead of one per
    pair.

    use_rel=True triangulates in the pair's own frame (identity | rel
    pose) — the baseline case, where the second pose IS the output;
    otherwise the supplied global poses are used.
    Returns (pose_rel (P,6), em2 (P,F), pts (P,F,3), keep (P,F),
    n_inl (P,))."""

    def one(kp_a, kp_b, idx, mask, intr_a, intr_b, pose_a, pose_b, key):
        uv1 = kp_a
        uv2 = kp_b[idx]
        xy1 = undistort_points(intr_a, uv1)
        xy2 = undistort_points(intr_b, uv2)
        f = intr_a[0]
        pose_e, em2, pose_h, hm2, use_h = _dual_model_pose(
            key, xy1, xy2, mask, thresh_px / f
        )
        pose_rel = jnp.where(use_h, pose_h, pose_e)
        em_out = jnp.where(use_h, hm2, em2)
        if use_rel:
            pa = jnp.zeros(6, kp_a.dtype)
            pb = pose_rel
        else:
            pa = pose_a
            pb = pose_b
        pts, keep, _errs = triangulate_pair(
            pa, pb, intr_a, intr_b, uv1, uv2,
            valid=em_out, max_reprojection_error=max_err,
        )
        return pose_rel, em_out, pts, keep, jnp.sum(em_out)

    return jax.vmap(one)(
        kp_a, kp_b, idx, mask, intr_a, intr_b, pose_a, pose_b, keys
    )


def _homography_ratios(scene: Scene, match_idx, match_mask, pairs, thresh, seed):
    """Batched homography inlier ratio per pair (lax.map chunks)."""
    kp = jnp.asarray(scene.keypoints)

    @jax.jit
    def go(pairs_d, idx_d, mask_d):
        def one(args):
            pair, idx, mask, key = args
            uv1 = kp[pair[0]]
            uv2 = kp[pair[1]][idx]
            return homography_inlier_ratio(key, uv1, uv2, mask, thresh)

        keys = jax.random.split(jax.random.key(seed), pairs_d.shape[0])
        return jax.lax.map(one, (pairs_d, idx_d, mask_d, keys), batch_size=8)

    return np.asarray(
        go(jnp.asarray(pairs), jnp.asarray(match_idx), jnp.asarray(match_mask))
    )


# ------------------------------------------------------------------- driver
def reconstruct(
    scene: Scene,
    pairs: np.ndarray,
    config: SfMConfig | None = None,
    log=lambda *a: None,
) -> dict:
    """Run incremental SfM on a scene with extracted features.

    pairs: (P, 2) int32 candidate pairs from a pair policy.
    Mutates `scene` in place; returns stats dict.
    """
    cfg = config or SfMConfig()
    S, F = scene.feat_valid.shape
    w_img, h_img = scene.image_size
    max_dim = float(max(w_img, h_img))
    thr_match = _resolve_thresh(cfg.ransac_matching_threshold, max_dim)
    thr_base = _resolve_thresh(cfg.ransac_baseline_threshold, max_dim)
    thr_pose = _resolve_thresh(cfg.ransac_pose_threshold, max_dim)
    key = jax.random.key(cfg.seed)

    # ---- 1. match all candidate pairs (the sharded hot loop)
    log(f"matching {len(pairs)} pairs")
    t_match = time.perf_counter()
    match_descs = scene.descriptors
    if cfg.binary_descriptors:
        match_descs = match_descs.astype(jnp.bfloat16)
    if len(jax.devices()) > 1 and len(pairs) >= len(jax.devices()):
        # pair-sharded matching over the device mesh (SURVEY.md §2.7 (2))
        from sfm_mvs_pipeline.parallel.matching import match_pairs_sharded
        from sfm_mvs_pipeline.parallel.mesh import make_mesh

        log(f"pair-sharded matching over {len(jax.devices())} devices")
        midx, mmask, mdist = match_pairs_sharded(
            make_mesh(), match_descs, scene.feat_valid, pairs,
            ratio=cfg.lowe_ratio,
            distinct=cfg.distinct_matches,
            method=cfg.matcher_method,
            with_distance=True,
            exact=cfg.exact_match,
        )
    else:
        midx, mmask, mdist = M.match_pairs_batch(
            jnp.asarray(match_descs),
            jnp.asarray(scene.feat_valid),
            jnp.asarray(pairs),
            ratio=cfg.lowe_ratio,
            distinct=cfg.distinct_matches,
            method=cfg.matcher_method,
            with_distance=True,
            exact=cfg.exact_match,
        )
    midx = np.asarray(midx)
    mmask = np.asarray(mmask)
    mdist = np.asarray(mdist)
    counts = mmask.sum(axis=1)
    live = counts >= cfg.min_match_count  # ref min-match filter (SfM.cpp:566-570)
    log(
        f"pairs with >= {cfg.min_match_count} matches: {int(live.sum())} "
        f"(matching wall {time.perf_counter() - t_match:.3f} s)"
    )

    # ---- 2. homography inlier ratios (pair ordering metric)
    ratios = _homography_ratios(
        scene, midx, mmask, pairs, thr_match, cfg.seed
    )
    ratios = np.where(live, ratios, -1.0)

    # f64 host state runs at the canonical device dtype (f32 unless x64 is on)
    _dt = jax.dtypes.canonicalize_dtype(np.float64)
    intr_d = jnp.asarray(scene.intrinsics, _dt)
    kp_d = jnp.asarray(scene.keypoints, _dt)

    pair_matches = {}  # (a, b) -> (idx_a, idx_b, match_distance) compact
    for k_, (a, b) in enumerate(pairs):
        if live[k_]:
            q = np.nonzero(mmask[k_])[0]
            pair_matches[(int(a), int(b))] = (
                q.astype(np.int32), midx[k_][q], mdist[k_][q]
            )

    queue = {(int(a), int(b)) for k_, (a, b) in enumerate(pairs) if live[k_]}
    done_pairs, failed_pairs = [], []
    stats = {"baseline": None, "ba_runs": 0, "views": 0}

    def intr_of(s):
        return intr_d[scene.cam_of_shot[s]]

    def run_ba():
        nonlocal intr_d
        model = CAMERA_MODELS[scene.camera_model]
        imask = np.zeros((len(scene.intrinsics), 7))
        imask[:, list(model.opt_mask)] = 1.0
        n_dev = len(jax.devices())
        n_live = int((scene.obs_w > 0).sum())
        ba_args = (
            scene.points.astype(np.float64),
            scene.poses,
            scene.intrinsics,
            scene.cam_of_shot,
            scene.obs_point,
            scene.obs_shot,
            scene.obs_uv.astype(np.float64),
            scene.obs_w.astype(np.float64),
            imask,
        )
        if n_dev > 1 and n_live >= 2048 * n_dev:
            # point-sharded distributed BA over the mesh (SURVEY.md §2.7 (3))
            from sfm_mvs_pipeline.parallel.ba import (
                run_bundle_adjustment_sharded,
            )
            from sfm_mvs_pipeline.parallel.mesh import make_mesh

            log(f"point-sharded bundle adjustment over {n_dev} devices")
            out = run_bundle_adjustment_sharded(
                make_mesh(), *ba_args,
                pose_free=scene.recovered.astype(np.float64),
                config=cfg.ba,
            )
        else:
            out = run_bundle_adjustment(
                *ba_args,
                pose_free=scene.recovered.astype(np.float64),
                config=cfg.ba,
            )
        scene.points = out["points"]
        scene.poses = out["poses"]
        scene.intrinsics = out["intrinsics"]
        # refresh the device copy: BA just changed f/k1/k2, and every later
        # PnP / pair pose / triangulation must see the SAME intrinsics the
        # points were optimized under (a stale copy made PnP reject views
        # with near-zero inlier ratios on the insel sequence config)
        intr_d = jnp.asarray(scene.intrinsics, _dt)
        stats["ba_runs"] += 1
        n_live = max(int((scene.obs_w > 0).sum()), 1)
        log(
            f"BA #{stats['ba_runs']}: cost {out['cost']:.3g} "
            f"({out['iterations']} iters, rms "
            f"{np.sqrt(2 * out['cost'] / n_live):.3f} px)"
        )

    def pair_pose(a, b, thresh):
        nonlocal key
        key, sub = jax.random.split(key)
        ia, ib, _ = pair_matches[(a, b)]
        idx = np.zeros(F, np.int32)
        mask = np.zeros(F, bool)
        idx[ia] = ib
        mask[ia] = True
        pose, em = _pair_pose_jit(
            kp_d[a], kp_d[b], jnp.asarray(idx), jnp.asarray(mask),
            intr_of(a), intr_of(b), thresh, sub,
        )
        return np.asarray(pose), np.asarray(em), mask

    def _full_mask(a, b):
        ia, _, _ = pair_matches[(a, b)]
        mask = np.zeros(F, bool)
        mask[ia] = True
        return mask

    def pairs_fused(pair_list, use_rel, thresh):
        """Essential+pose+triangulation for a SET of pairs in one
        dispatch (r5): returns host (pose_rel, em2, pts, keep, n_inl)
        stacks. Pads to a power-of-two pair count for compile-bucket
        stability (padded rows repeat pair 0 with fresh keys; callers
        slice to len(pair_list))."""
        nonlocal key
        n = len(pair_list)
        cap = 1
        while cap < n:
            cap *= 2
        padded = list(pair_list) + [pair_list[0]] * (cap - n)
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, cap)
        A = np.asarray([p[0] for p in padded])
        B = np.asarray([p[1] for p in padded])
        idxs = np.stack([_full_idx(a, b) for a, b in padded])
        masks = np.stack([_full_mask(a, b) for a, b in padded])
        out = _pairs_fused_jit(
            kp_d[A], kp_d[B], jnp.asarray(idxs), jnp.asarray(masks),
            intr_d[scene.cam_of_shot[A]], intr_d[scene.cam_of_shot[B]],
            jnp.asarray(scene.poses[A], _dt), jnp.asarray(scene.poses[B], _dt),
            thresh, cfg.max_reprojection_error, keys, use_rel,
        )
        pose_rel, em2, pts, keep, n_inl = jax.device_get(out)
        return (
            pose_rel[:n], em2[:n], pts[:n], keep[:n], n_inl[:n], masks[:n]
        )

    def triangulate_and_merge(a, b, em):
        """Triangulate inlier matches of a recovered pair and merge into
        tracks (the reference's mergePointcloudElement3d2d by shared
        feature; Scene.cpp:470-561)."""
        pts, keep = _triangulate_pair_jit(
            jnp.asarray(scene.poses[a]),
            jnp.asarray(scene.poses[b]),
            intr_of(a),
            intr_of(b),
            kp_d[a],
            kp_d[b],
            jnp.asarray(_full_idx(a, b)),
            jnp.asarray(em),
            cfg.max_reprojection_error,
        )
        pts = np.asarray(pts)
        keep = np.asarray(keep)
        return merge_pair_points(a, b, pts, keep)

    def merge_pair_points(a, b, pts, keep):
        """Host-side track bookkeeping for one pair's triangulated points
        (pts (F, 3), keep (F,) numpy)."""
        idx_b = _full_idx(a, b)
        i_all = np.nonzero(keep)[0]
        j_all = idx_b[i_all]
        pa = scene.point_of_feat[a, i_all]
        pb = scene.point_of_feat[b, j_all]

        # extend track on the untracked side (vectorized index join)
        ext_a = (pb >= 0) & (pa < 0)  # b's feature tracked -> add obs in a
        ext_b = (pa >= 0) & (pb < 0)
        if ext_a.any():
            scene.add_observations(
                pb[ext_a], np.full(ext_a.sum(), a), i_all[ext_a],
                scene.keypoints[a, i_all[ext_a]],
            )
        if ext_b.any():
            scene.add_observations(
                pa[ext_b], np.full(ext_b.sum(), b), j_all[ext_b],
                scene.keypoints[b, j_all[ext_b]],
            )

        # brand-new tracks
        new = (pa < 0) & (pb < 0)
        i_new = i_all[new]
        j_new = j_all[new]
        n_new = len(i_new)
        if n_new:
            pids = np.arange(
                scene.n_points, scene.n_points + n_new, dtype=np.int32
            )
            scene.points = np.concatenate([scene.points, pts[i_new]])
            scene.point_valid = np.concatenate(
                [scene.point_valid, np.ones(n_new, bool)]
            )
            scene.colors = np.concatenate(
                [scene.colors, np.zeros((n_new, 4), np.uint8)]
            )
            scene.obs_point = np.concatenate([scene.obs_point, pids, pids])
            scene.obs_shot = np.concatenate(
                [
                    scene.obs_shot,
                    np.full(n_new, a, np.int32),
                    np.full(n_new, b, np.int32),
                ]
            )
            scene.obs_feat = np.concatenate([scene.obs_feat, i_new, j_new])
            scene.obs_uv = np.concatenate(
                [
                    scene.obs_uv,
                    scene.keypoints[a, i_new],
                    scene.keypoints[b, j_new],
                ]
            )
            scene.obs_w = np.concatenate(
                [scene.obs_w, np.ones(2 * n_new, np.float32)]
            )
            scene.point_of_feat[a, i_new] = pids
            scene.point_of_feat[b, j_new] = pids

        # track FUSION: a match linking two existing tracks merges them when
        # both gates of the reference's mergePointcloudElement3d2d hold —
        # 3D distance <= point_merge_distance AND the linking match's
        # descriptor distance <= feature_merge_distance
        # (ref: Scene.cpp:470-561, gates at :483 and :532)
        n_fused = 0
        both = (pa >= 0) & (pb >= 0) & (pa != pb)
        if both.any() and cfg.point_merge_distance > 0:
            dist_full = _full_dist(a, b)
            for ii in np.nonzero(both)[0]:
                p, q = int(pa[ii]), int(pb[ii])
                # follow merges applied earlier in this loop
                while not scene.point_valid[p] and scene.point_alias.get(p) is not None:
                    p = scene.point_alias[p]
                while not scene.point_valid[q] and scene.point_alias.get(q) is not None:
                    q = scene.point_alias[q]
                if p == q or not (scene.point_valid[p] and scene.point_valid[q]):
                    continue
                if dist_full[i_all[ii]] > cfg.feature_merge_distance:
                    continue
                if (
                    np.linalg.norm(scene.points[p] - scene.points[q])
                    > cfg.point_merge_distance
                ):
                    continue
                if q < p:  # keep the older point as parent (ref keeps the
                    p, q = q, p  # existing candidate's coordinates)
                sel = np.nonzero((scene.obs_point == q) & (scene.obs_w > 0))[0]
                scene.obs_point[sel] = p
                for o in sel:
                    scene.point_of_feat[scene.obs_shot[o], scene.obs_feat[o]] = p
                scene.point_valid[q] = False
                scene.point_alias[q] = p
                n_fused += 1

        return n_new, int(ext_a.sum() + ext_b.sum()) + n_fused

    def _full_dist(a, b):
        ia, _, dd = pair_matches[(a, b)]
        dist = np.full(F, np.inf, np.float64)
        dist[ia] = dd
        return dist

    def _full_idx(a, b):
        ia, ib, _ = pair_matches[(a, b)]
        idx = np.zeros(F, np.int32)
        idx[ia] = ib
        return idx

    # ---- 3. baseline pair (ref: SfM.cpp:176-245)
    order = [
        k_
        for k_ in np.argsort(ratios, kind="stable")
        if live[k_]
        and ratios[k_] >= cfg.min_homography_inlier_ratio
        and counts[k_] >= cfg.baseline_min_matches
    ]
    if not order:  # fall back: allow any live pair ordered by ratio
        order = [
            k_
            for k_ in np.argsort(ratios, kind="stable")
            if live[k_] and ratios[k_] >= 0
        ]
    baseline_found = False
    # speculative batch (r5): pose + triangulation for up to 8 candidate
    # pairs in ONE dispatch; the host then walks the results in order —
    # a failed first candidate costs nothing extra
    for start in range(0, len(order), 8):
        chunk = order[start : start + 8]
        cand_pairs = [
            (int(pairs[k_][0]), int(pairs[k_][1])) for k_ in chunk
        ]
        try:
            pose_rel_c, em_c, pts_c, keep_c, n_inl_c, masks_c = pairs_fused(
                cand_pairs, use_rel=True, thresh=thr_base
            )
        except Exception as e:  # numerical failure: sequential fallback
            log(f"batched baseline scan failed ({e}); sequential retry")
            pose_rel_c = None
        if pose_rel_c is None:
            for k_, (a, b) in zip(chunk, cand_pairs):
                log(f"trying baseline pair ({a}, {b}) ratio={ratios[k_]:.3f}")
                try:
                    pose_rel, em, mask = pair_pose(a, b, thr_base)
                except Exception as e:
                    log(f"baseline pose failed: {e}")
                    continue
                pose_ratio = em.sum() / max(mask.sum(), 1)
                if pose_ratio < cfg.min_pose_inlier_ratio:
                    log(f"pose inlier ratio too low: {pose_ratio:.3f}")
                    continue
                scene.poses[a] = 0.0
                scene.poses[b] = pose_rel
                scene.recovered[a] = True
                scene.recovered[b] = True
                n_new, _ = triangulate_and_merge(a, b, em)
                log(f"baseline ({a}, {b}): {n_new} points")
                queue.discard((a, b))
                done_pairs.append((a, b))
                stats["baseline"] = (a, b)
                stats["views"] = 2
                baseline_found = True
                break
            if baseline_found:
                break
            continue
        for j, (k_, (a, b)) in enumerate(zip(chunk, cand_pairs)):
            log(f"trying baseline pair ({a}, {b}) ratio={ratios[k_]:.3f}")
            pose_ratio = n_inl_c[j] / max(masks_c[j].sum(), 1)
            if pose_ratio < cfg.min_pose_inlier_ratio:
                log(f"pose inlier ratio too low: {pose_ratio:.3f}")
                continue
            scene.poses[a] = 0.0
            scene.poses[b] = pose_rel_c[j]
            scene.recovered[a] = True
            scene.recovered[b] = True
            n_new, _ = merge_pair_points(a, b, pts_c[j], keep_c[j])
            log(f"baseline ({a}, {b}): {n_new} points")
            queue.discard((a, b))
            done_pairs.append((a, b))
            stats["baseline"] = (a, b)
            stats["views"] = 2
            baseline_found = True
            break
        if baseline_found:
            break
    if not baseline_found:
        log("no baseline pair could be triangulated")
        return stats
    run_ba()

    # ---- 4. incremental loop (ref: SfM.cpp:247-375)
    while queue:
        remaining_shots = sorted(
            {s for p in queue for s in p if not scene.recovered[s]}
        )
        if not remaining_shots:
            break
        # pick the shot with the most 3D-2D correspondences
        best_shot, best_n, best_corr = -1, -1, None
        for s in remaining_shots:
            pids, fids, uv = scene.find_2d3d(s, pair_matches)
            if len(pids) > best_n:
                best_shot, best_n, best_corr = s, len(pids), (pids, fids, uv)
        if best_n <= 0:
            break
        s = best_shot
        pids, fids, uv = best_corr
        log(f"registering shot {s} with {best_n} 3D-2D correspondences")

        # PnP (ref: findCameraPoseFrom3d2dMatch, 100 iters, SfM.cpp:478)
        npts = len(pids)
        cap = 8
        while cap < npts:
            cap *= 2
        X = np.zeros((cap, 3))
        U = np.zeros((cap, 2))
        V = np.zeros(cap, bool)
        X[:npts] = scene.points[pids]
        U[:npts] = uv
        V[:npts] = True
        key, sub = jax.random.split(key)
        try:
            pose, inl, ratio = solve_pnp_ransac(
                sub, jnp.asarray(X), jnp.asarray(U), intr_of(s),
                jnp.asarray(V), thr_pose, k_hyp=256,
            )
            ratio = float(ratio)
        except Exception as e:
            log(f"PnP failed: {e}")
            ratio = -1.0
        if ratio < cfg.min_pose_inlier_ratio:
            log(f"pose inlier ratio too low ({ratio:.3f}); dropping shot {s}")
            dead = [p for p in queue if s in p]
            for p in dead:
                queue.discard(p)
                failed_pairs.append(p)
            continue
        scene.poses[s] = np.asarray(pose)
        scene.recovered[s] = True
        stats["views"] += 1

        # register the PnP INLIER correspondences as observations of the
        # new view. The reference reaches the same links indirectly (each
        # adjoining pair's triangulations merge into existing tracks by
        # shared feature, Scene.cpp:470-561), but in feature-starved
        # regimes the adjoining pairs can fall under the 20-match floor
        # and contribute almost nothing — observed as views entering BA
        # with ~3 observations (a 6-dof pose on 6 residuals), whose junk
        # poses then corrupt the map. The PnP inliers are exactly the
        # verified links; record them (one per feature, untracked, live
        # point) so BA actually constrains the new pose.
        inl_np = np.asarray(inl)[:npts]
        sel = np.nonzero(inl_np)[0]
        if len(sel):
            p_sel = np.asarray(pids)[sel]
            f_sel = np.asarray(fids)[sel]
            f_sel, first = np.unique(f_sel, return_index=True)
            p_sel = p_sel[first]
            ok = scene.point_valid[p_sel] & (
                scene.point_of_feat[s, f_sel] < 0
            )
            if ok.any():
                scene.add_observations(
                    p_sel[ok], np.full(int(ok.sum()), s), f_sel[ok],
                    scene.keypoints[s, f_sel[ok]],
                )

        # process adjoining recovered pairs (ref: SfM.cpp:333-371) —
        # all of them in ONE fused dispatch (r5)
        adjoining = [
            p
            for p in sorted(queue)
            if s in p and scene.recovered[p[0]] and scene.recovered[p[1]]
        ]
        if adjoining:
            try:
                _pr, _em, pts_c, keep_c, _ni, _mk = pairs_fused(
                    adjoining, use_rel=False, thresh=thr_base
                )
            except Exception as e:
                log(f"batched pair processing failed ({e}); sequential")
                pts_c = None
            for j, (a, b) in enumerate(adjoining):
                if pts_c is not None:
                    n_new, n_ext = merge_pair_points(a, b, pts_c[j], keep_c[j])
                else:
                    try:
                        _, em, _ = pair_pose(a, b, thr_base)
                    except Exception as e:
                        log(f"pair ({a},{b}) pose failed: {e}")
                        continue
                    n_new, n_ext = triangulate_and_merge(a, b, em)
                log(
                    f"pair ({a}, {b}): +{n_new} points, "
                    f"+{n_ext} track extensions"
                )
                queue.discard((a, b))
                done_pairs.append((a, b))
        # collapse UNLINKED duplicate tracks by pure 3D distance (the batch
        # equivalent of the reference's mergePointcloudElement,
        # Scene.cpp:435-468), same gate as the linked fusion above
        n_spatial = scene.merge_close_points(cfg.point_merge_distance)
        if n_spatial:
            log(f"spatial merge: {n_spatial} duplicate tracks collapsed")
        if cfg.ba_every_view:
            run_ba()
    if not cfg.ba_every_view:
        run_ba()

    stats["points"] = scene.n_points
    stats["observations"] = scene.n_obs
    stats["recovered"] = int(scene.recovered.sum())
    stats["done_pairs"] = len(done_pairs)
    stats["failed_pairs"] = len(failed_pairs)
    return stats
