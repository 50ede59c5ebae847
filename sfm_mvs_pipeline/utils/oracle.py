"""cv2-oracle incremental SfM: an independent reference trajectory.

The acceptance metric (BASELINE.json) is ATE against the reference binary's
trajectory on the insel configs. The reference binary (C++/OpenCV/Ceres)
does not build in this environment, but every primitive of its SfM state
machine (ref: src/photogrammetrie/sfm/SfM.cpp:143-381) is available through
cv2 + scipy, which are already the test oracles for the per-op unit tests.
This module re-enacts that exact call stack with OpenCV primitives and an
independent scipy LM bundle adjustment (standing in for Ceres DENSE_SCHUR,
ref: src/photogrammetrie/util/CeresUtils.cpp:43-50), producing an oracle
trajectory + sparse cloud that shares NO code with this pipeline:

  cv2.SIFT(limit, 3, 0.09)                 PhotogrammetrieCli.cpp:354
  BFMatcher.knnMatch k=2, Lowe 0.7         UnorderedFeatureMatchingStrategy.cpp:50-65
  cv2.findHomography RANSAC (ratio order)  SfM.cpp:599-637, :176-194
  cv2.findEssentialMat + recoverPose       SfM.cpp:491-540
  cv2.triangulatePoints + reproj filter    SfM.cpp:383-451
  cv2.solvePnPRansac (100 iters)           SfM.cpp:453-489
  scipy least_squares LM bundle adjust     BundleAdjustment.cpp:29-140

Thresholds are the reference CLI defaults (PhotogrammetrieCli.cpp:95-110):
match-threshold 20, baseline-homography-threshold 100, inlier ratios 0.4,
ransac matching/baseline/pose thresholds -3/-1/-8 (negative = absolute px),
reprojection-error-threshold 10, SimpleRadial camera f=1.2*maxdim.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class OracleConfig:
    feature_limit: int = 10000
    lowe_ratio: float = 0.7
    min_match_count: int = 20
    baseline_min_matches: int = 100
    min_homography_inlier_ratio: float = 0.4
    min_pose_inlier_ratio: float = 0.4
    thr_match_px: float = 3.0
    thr_baseline_px: float = 1.0
    thr_pose_px: float = 8.0
    max_reprojection_error: float = 10.0
    run_ba: bool = True


def _project(K, dist, rvec, tvec, X):
    import cv2

    proj, _ = cv2.projectPoints(
        X.reshape(-1, 1, 3), rvec, tvec, K, dist
    )
    return proj.reshape(-1, 2)


def _ba(points, rvecs, tvecs, f, k1, k2, obs, img_size, fixed_cams):
    """Independent LM bundle adjustment over (points, poses, [f,k1,k2]).

    obs: list of (point_id, shot_id, uv). Mirrors the reference's residual
    structure: one 2-vector reprojection residual per observation with
    parameter blocks point[3], pose[6], camera[f,k1,k2]
    (ref: src/photogrammetrie/common/BundleAdjustment.cpp:50-90 and the
    SimpleRadialCamera functor, SimpleRadialCamera.cpp:69-116)."""
    from scipy.optimize import least_squares
    from scipy.sparse import lil_matrix

    n_pts = len(points)
    n_cams = len(rvecs)
    cx, cy = img_size[0] / 2.0, img_size[1] / 2.0
    pt_ids = np.array([o[0] for o in obs])
    cam_ids = np.array([o[1] for o in obs])
    uvs = np.array([o[2] for o in obs])

    def pack():
        return np.concatenate(
            [np.asarray(points).ravel()]
            + [np.concatenate([rvecs[c].ravel(), tvecs[c].ravel()]) for c in range(n_cams)]
            + [[f, k1, k2]]
        )

    def unpack(x):
        pts = x[: n_pts * 3].reshape(n_pts, 3)
        cams = x[n_pts * 3: n_pts * 3 + n_cams * 6].reshape(n_cams, 6)
        f_, k1_, k2_ = x[-3:]
        return pts, cams, f_, k1_, k2_

    def residuals(x):
        pts, cams, f_, k1_, k2_ = unpack(x)
        # SimpleRadial projection: x * (1 + k1 r^2 + k2 r^4) * f + c
        res = np.empty((len(obs), 2))
        for c in range(n_cams):
            sel = cam_ids == c
            if not sel.any():
                continue
            rv = cams[c, :3]
            theta = np.linalg.norm(rv)
            if theta < 1e-12:
                R = np.eye(3)
            else:
                import cv2

                R, _ = cv2.Rodrigues(rv)
            X = pts[pt_ids[sel]] @ R.T + cams[c, 3:]
            xy = X[:, :2] / X[:, 2:3]
            r2 = (xy**2).sum(axis=1, keepdims=True)
            d = 1.0 + k1_ * r2 + k2_ * r2 * r2
            res[sel] = xy * d * f_ + np.array([cx, cy]) - uvs[sel]
        return res.ravel()

    # bipartite jacobian sparsity (point block + cam block + shared cam params)
    A = lil_matrix((len(obs) * 2, n_pts * 3 + n_cams * 6 + 3), dtype=int)
    for i, (p, c, _uv) in enumerate(obs):
        A[2 * i: 2 * i + 2, p * 3: p * 3 + 3] = 1
        if c not in fixed_cams:
            A[2 * i: 2 * i + 2, n_pts * 3 + c * 6: n_pts * 3 + c * 6 + 6] = 1
        A[2 * i: 2 * i + 2, -3:] = 1
    sol = least_squares(
        residuals, pack(), jac_sparsity=A, method="trf", max_nfev=60,
        ftol=1e-6, xtol=1e-8, verbose=0,
    )
    pts, cams, f_, k1_, k2_ = unpack(sol.x)
    for c in range(n_cams):
        if c in fixed_cams:
            continue
        rvecs[c] = cams[c, :3].reshape(3, 1)
        tvecs[c] = cams[c, 3:].reshape(3, 1)
    return pts, f_, k1_, k2_


def oracle_reconstruct(image_paths, config: OracleConfig | None = None,
                       size=None, pairs=None, log=lambda *a: None) -> dict:
    """Run the cv2-oracle incremental SfM.

    Returns dict with centers (S, 3) camera centers in recovery order of
    shot id, rvecs/tvecs per recovered shot, points (P, 3), f/k1/k2.
    size: optional (w, h) to resize inputs (default: native size).
    pairs: optional iterable of (a, b) candidate pairs (a < b) — the pair
    policy (unordered default; pass a video/grid pair list to mirror the
    reference's strategy selection, SfM.cpp strategies).
    """
    import cv2

    cfg = config or OracleConfig()
    imgs = []
    for p in image_paths:
        img = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
        if size is not None:
            img = cv2.resize(img, size, interpolation=cv2.INTER_AREA)
        imgs.append(img)
    h, w = imgs[0].shape
    S = len(imgs)

    # intrinsics init (ref: PhotogrammetrieCli.cpp:312-314)
    f = 1.2 * max(w, h)
    k1 = k2 = 0.0

    def K_of():
        return np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]])

    def dist_of():
        return np.array([k1, k2, 0.0, 0.0])

    sift = cv2.SIFT_create(
        nfeatures=cfg.feature_limit, nOctaveLayers=3, contrastThreshold=0.09
    )
    kps, descs = [], []
    for img in imgs:
        kp, ds = sift.detectAndCompute(img, None)
        kps.append(np.array([k.pt for k in kp]))
        descs.append(ds)
        log(f"oracle: {len(kp)} SIFT features")

    bf = cv2.BFMatcher(cv2.NORM_L2)
    pair_matches = {}
    ratios = {}
    cand = (
        [(a, b) for a in range(S) for b in range(a + 1, S)]
        if pairs is None else [tuple(p) for p in pairs]
    )
    for a, b in cand:
        if True:
            if descs[a] is None or descs[b] is None:
                continue
            knn = bf.knnMatch(descs[a], descs[b], k=2)
            good = [
                m for m, n in (p for p in knn if len(p) == 2)
                if m.distance < cfg.lowe_ratio * n.distance
            ]
            if len(good) < cfg.min_match_count:
                continue
            ia = np.array([m.queryIdx for m in good])
            ib = np.array([m.trainIdx for m in good])
            pair_matches[(a, b)] = (ia, ib)
            _, hm = cv2.findHomography(
                kps[a][ia], kps[b][ib], cv2.RANSAC, cfg.thr_match_px
            )
            ratios[(a, b)] = float(hm.sum()) / len(good) if hm is not None else 1.0
            log(f"oracle pair ({a},{b}): {len(good)} matches, "
                f"h-ratio {ratios[(a, b)]:.3f}")

    # shared state
    rvecs = {s: None for s in range(S)}
    tvecs = {s: None for s in range(S)}
    recovered = set()
    points = []  # list of 3D
    track_of = {}  # (shot, feat) -> point id
    obs = []  # (point_id, shot, uv)

    def triangulate_pair(a, b):
        """Triangulate pair matches; extend/merge tracks (SfM.cpp:383-451)."""
        K = K_of()
        dist = dist_of()
        ia, ib = pair_matches[(a, b)]
        P1 = K @ np.hstack([cv2.Rodrigues(rvecs[a])[0], tvecs[a]])
        P2 = K @ np.hstack([cv2.Rodrigues(rvecs[b])[0], tvecs[b]])
        ua = cv2.undistortPoints(
            kps[a][ia].reshape(-1, 1, 2), K, dist, P=K
        ).reshape(-1, 2)
        ub = cv2.undistortPoints(
            kps[b][ib].reshape(-1, 1, 2), K, dist, P=K
        ).reshape(-1, 2)
        X4 = cv2.triangulatePoints(P1, P2, ua.T, ub.T)
        X = (X4[:3] / X4[3]).T
        # cheirality + reprojection filter
        for k in range(len(ia)):
            x = X[k]
            ok = True
            for s, u in ((a, kps[a][ia[k]]), (b, kps[b][ib[k]])):
                Xc = cv2.Rodrigues(rvecs[s])[0] @ x + tvecs[s].ravel()
                if Xc[2] <= 0:
                    ok = False
                    break
                pr = _project(K, dist, rvecs[s], tvecs[s], x[None])[0]
                if np.linalg.norm(pr - u) > cfg.max_reprojection_error:
                    ok = False
                    break
            if not ok:
                continue
            ta = track_of.get((a, ia[k]))
            tb = track_of.get((b, ib[k]))
            if ta is not None and tb is None:
                track_of[(b, ib[k])] = ta
                obs.append((ta, b, kps[b][ib[k]]))
            elif tb is not None and ta is None:
                track_of[(a, ia[k])] = tb
                obs.append((tb, a, kps[a][ia[k]]))
            elif ta is None and tb is None:
                pid = len(points)
                points.append(x)
                track_of[(a, ia[k])] = pid
                track_of[(b, ib[k])] = pid
                obs.append((pid, a, kps[a][ia[k]]))
                obs.append((pid, b, kps[b][ib[k]]))

    def run_ba():
        nonlocal f, k1, k2, points
        if not cfg.run_ba or not points:
            return
        rec = sorted(recovered)
        cam_idx = {s: i for i, s in enumerate(rec)}
        ob = [(p, cam_idx[s], uv) for (p, s, uv) in obs if s in cam_idx]
        rv = [rvecs[s].copy() for s in rec]
        tv = [tvecs[s].copy() for s in rec]
        pts, f, k1, k2 = _ba(
            np.array(points), rv, tv, f, k1, k2, ob, (w, h), fixed_cams=set()
        )
        points = list(pts)
        for i, s in enumerate(rec):
            rvecs[s] = rv[i]
            tvecs[s] = tv[i]

    # baseline (ref: SfM.cpp:176-245 — ascending homography-ratio order)
    order = sorted(
        (p for p in pair_matches
         if ratios[p] >= cfg.min_homography_inlier_ratio
         and len(pair_matches[p][0]) >= cfg.baseline_min_matches),
        key=lambda p: ratios[p],
    ) or sorted(pair_matches, key=lambda p: ratios[p])
    queue = set(pair_matches)
    baseline = None
    for (a, b) in order:
        K = K_of()
        ia, ib = pair_matches[(a, b)]
        ua = cv2.undistortPoints(
            kps[a][ia].reshape(-1, 1, 2), K, dist_of(), P=K
        ).reshape(-1, 2)
        ub = cv2.undistortPoints(
            kps[b][ib].reshape(-1, 1, 2), K, dist_of(), P=K
        ).reshape(-1, 2)
        E, em = cv2.findEssentialMat(
            ua, ub, K, cv2.RANSAC, 0.999, cfg.thr_baseline_px
        )
        if E is None or E.shape != (3, 3):
            continue
        n_in, R, t, _ = cv2.recoverPose(E, ua, ub, K, mask=em.copy())
        if n_in / len(ia) < cfg.min_pose_inlier_ratio:
            log(f"oracle baseline ({a},{b}) pose ratio too low")
            continue
        rvecs[a] = np.zeros((3, 1))
        tvecs[a] = np.zeros((3, 1))
        rvecs[b] = cv2.Rodrigues(R)[0]
        tvecs[b] = t.copy()
        recovered.update((a, b))
        triangulate_pair(a, b)
        queue.discard((a, b))
        baseline = (a, b)
        log(f"oracle baseline ({a},{b}): {len(points)} points")
        break
    if baseline is None:
        return {"centers": np.zeros((0, 3)), "recovered": []}
    run_ba()

    # incremental loop (ref: SfM.cpp:247-375)
    while queue:
        remaining = sorted(
            {s for p in queue for s in p if s not in recovered}
        )
        best_s, best_corr = None, None
        for s in remaining:
            X3, u2 = [], []
            seen_pts = set()
            for (a, b) in pair_matches:
                if s not in (a, b):
                    continue
                o = b if a == s else a
                if o not in recovered:
                    continue
                ia, ib = pair_matches[(a, b)]
                fs, fo = (ia, ib) if a == s else (ib, ia)
                for k in range(len(fs)):
                    pid = track_of.get((o, fo[k]))
                    if pid is not None and pid not in seen_pts:
                        seen_pts.add(pid)
                        X3.append(points[pid])
                        u2.append(kps[s][fs[k]])
            if best_corr is None or len(X3) > len(best_corr[0]):
                best_s, best_corr = s, (X3, u2)
        if best_s is None or len(best_corr[0]) < 4:
            break
        s = best_s
        X3 = np.array(best_corr[0])
        u2 = np.array(best_corr[1])
        ok, rv, tv, inl = cv2.solvePnPRansac(
            X3.reshape(-1, 1, 3), u2.reshape(-1, 1, 2), K_of(), dist_of(),
            iterationsCount=100, reprojectionError=cfg.thr_pose_px,
        )
        ratio = (len(inl) / len(X3)) if (ok and inl is not None) else 0.0
        if ratio < cfg.min_pose_inlier_ratio:
            log(f"oracle: shot {s} PnP ratio {ratio:.3f} too low, dropped")
            for p in [p for p in queue if s in p]:
                queue.discard(p)
            continue
        rvecs[s] = rv
        tvecs[s] = tv
        recovered.add(s)
        log(f"oracle: shot {s} registered ({len(X3)} corr, ratio {ratio:.2f})")
        for (a, b) in sorted(queue):
            if s in (a, b) and a in recovered and b in recovered:
                triangulate_pair(a, b)
                queue.discard((a, b))
        run_ba()

    rec = sorted(recovered)
    centers = np.array(
        [(-cv2.Rodrigues(rvecs[s])[0].T @ tvecs[s]).ravel() for s in rec]
    )
    return {
        "centers": centers,
        "recovered": rec,
        "rvecs": {s: rvecs[s] for s in rec},
        "tvecs": {s: tvecs[s] for s in rec},
        "points": np.array(points) if points else np.zeros((0, 3)),
        "f": f, "k1": k1, "k2": k2,
    }
