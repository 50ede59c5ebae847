"""SoA scene state for the incremental SfM driver.

Array-based replacement for the reference's mutable pointer-graph Scene
(shots / shotMatches / pointcloud with per-point Origin lists;
ref: src/photogrammetrie/common/Scene.h:35-510). All state is flat numpy on
the host; device kernels receive fixed-capacity array views. The key index
structure is `point_of_feat[S, F]`: the 3D point id currently associated
with each 2D feature (-1 = none). It turns the reference's O(points *
origins * matches) scans (Scene::find3d2dMatches, Scene.cpp:369-424) and its
merge-by-shared-feature pass (mergePointcloudElement3d2d, Scene.cpp:470-561)
into O(1) index joins.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Scene:
    # ---- per-shot feature arrays (fixed capacity F)
    keypoints: np.ndarray  # (S, F, 2) float32 pixel coords
    descriptors: np.ndarray  # (S, F, D) float32
    feat_valid: np.ndarray  # (S, F) bool
    image_paths: list  # len S
    image_size: tuple  # (width, height)

    # ---- cameras
    intrinsics: np.ndarray  # (C, 7) [f, cx, cy, k1, k2, p1, p2]
    cam_of_shot: np.ndarray  # (S,) int32
    camera_model: str  # key into models.cameras.CAMERA_MODELS

    # ---- poses
    poses: np.ndarray  # (S, 6) angle-axis | t (world->cam)
    recovered: np.ndarray  # (S,) bool

    # ---- sparse pointcloud + observation table (grow on host)
    points: np.ndarray  # (P, 3) float64 accumulating
    point_valid: np.ndarray  # (P,) bool
    colors: np.ndarray  # (P, 4) uint8 RGBA (filled by colorize)
    obs_point: np.ndarray  # (O,) int32
    obs_shot: np.ndarray  # (O,) int32
    obs_feat: np.ndarray  # (O,) int32 feature index within the shot
    obs_uv: np.ndarray  # (O, 2) float32
    obs_w: np.ndarray  # (O,) float32 weight (0 = dead)

    # ---- track index
    point_of_feat: np.ndarray  # (S, F) int32, -1 = unassigned
    # fused-track redirects: dead point id -> surviving parent id (filled by
    # the driver's merge pass; mirrors the reference's merge-into-parent,
    # Scene.cpp:563-567)
    point_alias: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def create(
        cls,
        image_paths: list,
        image_size: tuple,
        keypoints: np.ndarray,
        descriptors: np.ndarray,
        feat_valid: np.ndarray,
        intrinsics: np.ndarray,
        camera_model: str = "simple-radial",
        cam_of_shot: np.ndarray | None = None,
    ) -> "Scene":
        S, F = feat_valid.shape
        if intrinsics.ndim == 1:
            intrinsics = intrinsics[None, :]
        return cls(
            keypoints=np.asarray(keypoints, np.float32),
            descriptors=np.asarray(descriptors, np.float32),
            feat_valid=np.asarray(feat_valid, bool),
            image_paths=list(image_paths),
            image_size=tuple(image_size),
            intrinsics=np.asarray(intrinsics, np.float64),
            cam_of_shot=(
                np.zeros(S, np.int32) if cam_of_shot is None else cam_of_shot
            ),
            camera_model=camera_model,
            poses=np.zeros((S, 6), np.float64),
            recovered=np.zeros(S, bool),
            points=np.zeros((0, 3), np.float64),
            point_valid=np.zeros(0, bool),
            colors=np.zeros((0, 4), np.uint8),
            obs_point=np.zeros(0, np.int32),
            obs_shot=np.zeros(0, np.int32),
            obs_feat=np.zeros(0, np.int32),
            obs_uv=np.zeros((0, 2), np.float32),
            obs_w=np.zeros(0, np.float32),
            point_of_feat=np.full((S, F), -1, np.int32),
        )

    @property
    def n_shots(self) -> int:
        return len(self.poses)

    @property
    def n_points(self) -> int:
        return len(self.points)

    @property
    def n_obs(self) -> int:
        return len(self.obs_point)

    # ------------------------------------------------------------- mutation
    def add_points(
        self,
        xyz: np.ndarray,  # (N, 3)
        obs: list,  # list of (shot, feat, uv) tuples per point: [[(s,f,uv),(s,f,uv)], ...]
    ) -> np.ndarray:
        """Append new 3D points with their initial observations. Returns the
        new point ids."""
        n = len(xyz)
        ids = np.arange(self.n_points, self.n_points + n, dtype=np.int32)
        self.points = np.concatenate([self.points, np.asarray(xyz, np.float64)])
        self.point_valid = np.concatenate([self.point_valid, np.ones(n, bool)])
        self.colors = np.concatenate(
            [self.colors, np.zeros((n, 4), np.uint8)]
        )
        new_op, new_os, new_of, new_uv = [], [], [], []
        for pid, plist in zip(ids, obs):
            for s, fidx, uv in plist:
                new_op.append(pid)
                new_os.append(s)
                new_of.append(fidx)
                new_uv.append(uv)
                self.point_of_feat[s, fidx] = pid
        if new_op:
            self.obs_point = np.concatenate([self.obs_point, np.asarray(new_op, np.int32)])
            self.obs_shot = np.concatenate([self.obs_shot, np.asarray(new_os, np.int32)])
            self.obs_feat = np.concatenate([self.obs_feat, np.asarray(new_of, np.int32)])
            self.obs_uv = np.concatenate([self.obs_uv, np.asarray(new_uv, np.float32)])
            self.obs_w = np.concatenate([self.obs_w, np.ones(len(new_op), np.float32)])
        return ids

    def add_observations(self, point_ids, shots, feats, uvs) -> None:
        """Extend existing tracks with new observations (vectorized)."""
        point_ids = np.asarray(point_ids, np.int32)
        shots = np.asarray(shots, np.int32)
        feats = np.asarray(feats, np.int32)
        uvs = np.asarray(uvs, np.float32).reshape(-1, 2)
        self.obs_point = np.concatenate([self.obs_point, point_ids])
        self.obs_shot = np.concatenate([self.obs_shot, shots])
        self.obs_feat = np.concatenate([self.obs_feat, feats])
        self.obs_uv = np.concatenate([self.obs_uv, uvs])
        self.obs_w = np.concatenate([self.obs_w, np.ones(len(point_ids), np.float32)])
        self.point_of_feat[shots, feats] = point_ids

    def find_2d3d(self, shot: int, pair_matches: dict) -> tuple:
        """3D->2D correspondences for an unrecovered shot via index joins.

        pair_matches: {(a, b): (idx_a (M,), idx_b (M,), dist (M,))} compact
        match lists. Returns (point_ids (N,), feat_ids (N,), uv (N, 2))
        deduplicated on (point, feature) like
        ShotMatches3d2d::getDistinct3d2dPoints (ref: Scene.cpp:264-278).
        """
        pids, fids = [], []
        for (a, b), (ia, ib, _dist) in pair_matches.items():
            if a == shot and self.recovered[b]:
                other, idx_self, idx_other = b, ia, ib
            elif b == shot and self.recovered[a]:
                other, idx_self, idx_other = a, ib, ia
            else:
                continue
            pt = self.point_of_feat[other, idx_other]
            has = pt >= 0
            pids.append(pt[has])
            fids.append(idx_self[has])
        if not pids:
            return (
                np.zeros(0, np.int32),
                np.zeros(0, np.int32),
                np.zeros((0, 2), np.float32),
            )
        pids = np.concatenate(pids)
        fids = np.concatenate(fids)
        # distinct (3D point, 2D PIXEL) pairs — the reference dedupes on
        # the pixel coordinate (Scene.cpp:264-278), not the feature index:
        # orientation-duplicate keypoints (r5, cv2-parity secondary
        # orientations) share a pixel and must contribute ONE
        # correspondence, else PnP minimal sets draw rank-deficient
        # duplicate 3D points
        uv = self.keypoints[shot, fids]
        rows = np.empty(
            len(pids),
            dtype=[("p", np.int64), ("x", np.float32), ("y", np.float32)],
        )
        rows["p"] = pids
        rows["x"] = uv[:, 0]
        rows["y"] = uv[:, 1]
        _, uniq = np.unique(rows, return_index=True)
        uniq = np.sort(uniq)
        pids, fids = pids[uniq], fids[uniq]
        return pids, fids, self.keypoints[shot, fids]

    def kill_observations(self, mask_dead: np.ndarray) -> None:
        """Zero the weight of observations flagged dead (keeps shapes)."""
        self.obs_w = np.where(mask_dead, 0.0, self.obs_w).astype(np.float32)

    def merge_close_points(self, distance: float) -> int:
        """Pure 3D-distance track merge — the batch equivalent of the
        reference's Scene::mergePointcloudElement (ref: Scene.cpp:435-468):
        a point within `distance` of another is merged into it, keeping the
        existing (older) point's coordinates and moving all observations
        and feature links over.

        Unlike the match-linked fusion in the driver (which mirrors
        mergePointcloudElement3d2d, Scene.cpp:470-561), this collapses
        UNLINKED duplicate tracks — tracks that never shared a feature
        match but triangulated to the same 3D location. Neighbor search is
        a C kd-tree (scipy.spatial.cKDTree, the PCL KdTreeFLANN stand-in);
        the collapse itself is vectorized index remapping. Returns the
        number of points merged away.
        """
        if distance <= 0 or int(self.point_valid.sum()) < 2:
            return 0
        from scipy.spatial import cKDTree

        live = np.nonzero(self.point_valid)[0]
        pts = self.points[live]
        pairs = cKDTree(pts).query_pairs(distance, output_type="ndarray")
        if len(pairs) == 0:
            return 0
        # GREEDY nearest-first, NON-CHAINING: each point takes part in at
        # most one merge per pass. The reference merges one element into
        # its single nearest candidate (Scene.cpp:437-452); a transitive
        # union-find would instead collapse whole chains of points that
        # are pairwise-close but jointly spread far beyond `distance`.
        d = np.linalg.norm(pts[pairs[:, 0]] - pts[pairs[:, 1]], axis=1)
        order = np.argsort(d, kind="stable")
        roots = np.arange(self.n_points)
        touched = set()
        for k in order:
            i, j = live[pairs[k][0]], live[pairs[k][1]]
            if i in touched or j in touched:
                continue
            lo, hi = (i, j) if i < j else (j, i)
            # the LOWEST id survives (the oldest point, like the reference
            # keeping the existing candidate's coordinates)
            roots[hi] = lo
            touched.add(i)
            touched.add(j)
        dead = np.nonzero((roots != np.arange(self.n_points)) & self.point_valid)[0]
        if len(dead) == 0:
            return 0
        self.obs_point = roots[self.obs_point].astype(np.int32)
        m = self.point_of_feat >= 0
        self.point_of_feat[m] = roots[self.point_of_feat[m]]
        self.point_valid[dead] = False
        for d in dead:
            self.point_alias[int(d)] = int(roots[d])
        return len(dead)
