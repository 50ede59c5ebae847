"""Depth-map fusion: multi-view consistency filtering -> dense point cloud.

Replaces openMVS's depth-map fusion stage (ref: the fusion half of
DenseReconstruction, src/photogrammetrie/mvs/MVS.cpp:112-127, with the
reference's 3-view fusion-inlier requirement, MVS.h:62, and point merge
by reprojection distance `pointMergeDistance` 2.5 px, MVS.h:63).

Per reference view: unproject valid depths to world points, reproject into
every other view, count views whose own depth map agrees within a relative
tolerance; keep points with >= min_views agreement; consume the agreeing
pixels so later views don't re-emit duplicates (the openMVS dedup
equivalent). Normals from depth-map gradients, colors from the images.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from sfm_mvs_pipeline.models.cameras import intrinsics_to_K
from sfm_mvs_pipeline.ops.pose import aa_to_rotmat


@functools.partial(jax.jit, static_argnames=())
def unproject_depth(
    depth: jax.Array,  # (H, W)
    valid: jax.Array,  # (H, W)
    pose: jax.Array,  # (6,)
    intr: jax.Array,  # (7,)
):
    """Depth map -> world points (H, W, 3) + camera-frame normals -> world."""
    h, w = depth.shape
    K = intrinsics_to_K(intr)
    Kinv = jnp.linalg.inv(K)
    ys, xs = jnp.meshgrid(
        jnp.arange(h, dtype=depth.dtype), jnp.arange(w, dtype=depth.dtype),
        indexing="ij",
    )
    pix = jnp.stack([xs, ys, jnp.ones_like(xs)], axis=-1)  # (H, W, 3)
    rays = pix @ Kinv.T
    pts_cam = rays * depth[..., None]

    R = aa_to_rotmat(pose[:3])
    t = pose[3:]
    C = -R.T @ t
    pts_world = pts_cam @ R + C  # R^T x + C per row

    # normals via cross product of depth-surface tangents (camera frame)
    dx = jnp.gradient(pts_cam, axis=1)
    dy = jnp.gradient(pts_cam, axis=0)
    n_cam = jnp.cross(dy, dx)
    n_cam = n_cam / (jnp.linalg.norm(n_cam, axis=-1, keepdims=True) + 1e-12)
    # orient towards the camera (negative z in camera frame)
    flip = jnp.where(n_cam[..., 2:3] > 0, -1.0, 1.0)
    n_cam = n_cam * flip
    n_world = n_cam @ R
    return pts_world, n_world


@functools.partial(jax.jit, static_argnames=())
def project_points_depth(
    pts_world: jax.Array,  # (N, 3)
    pose: jax.Array,
    intr: jax.Array,
):
    """World points -> (u, v, z) in a view (no distortion at MVS scale —
    images are undistorted before densification like the reference exporter,
    OpenMvsUtils.cpp:136-150)."""
    R = aa_to_rotmat(pose[:3])
    t = pose[3:]
    pc = pts_world @ R.T + t
    z = pc[:, 2]
    K = intrinsics_to_K(intr)
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = K[0, 0] * pc[:, 0] / zs + K[0, 2]
    v = K[1, 1] * pc[:, 1] / zs + K[1, 2]
    return u, v, z


def fuse_depth_maps(
    depth_maps: np.ndarray,  # (V, H, W)
    valids: np.ndarray,  # (V, H, W) bool
    poses: np.ndarray,  # (V, 6)
    intr: np.ndarray,  # (7,)
    images_rgb: np.ndarray | None = None,  # (V, H, W, 3) uint8
    min_views: int = 3,
    rel_tolerance: float = 0.01,
    log=lambda *a: None,
) -> dict:
    """Fuse per-view depth maps into one consistent dense cloud.

    min_views counts the reference view itself (reference default: 3-view
    fusion inliers, MVS.h:62). Returns dict(points, normals, colors).
    """
    V, H, W = depth_maps.shape
    consumed = np.zeros((V, H, W), bool)
    out_pts, out_nrm, out_col = [], [], []

    d_dev = jnp.asarray(depth_maps)
    poses_dev = jnp.asarray(poses)
    intr_dev = jnp.asarray(intr)

    for r in range(V):
        vmask = valids[r] & ~consumed[r]
        if not vmask.any():
            continue
        pts_w, nrm_w = unproject_depth(
            d_dev[r], jnp.asarray(vmask), poses_dev[r], intr_dev
        )
        pts_w = np.asarray(pts_w)
        nrm_w = np.asarray(nrm_w)
        ys, xs = np.nonzero(vmask)
        P = pts_w[ys, xs]  # (N, 3)
        Nrm = nrm_w[ys, xs]

        agree = np.ones(len(P), np.int32)  # self
        agree_px: list[tuple[int, np.ndarray, np.ndarray, np.ndarray]] = []
        for n in range(V):
            if n == r:
                continue
            u, v, z = (
                np.asarray(x)
                for x in project_points_depth(
                    jnp.asarray(P), poses_dev[n], intr_dev
                )
            )
            ui = np.round(u).astype(np.int64)
            vi = np.round(v).astype(np.int64)
            inb = (z > 0) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
            uis = np.clip(ui, 0, W - 1)
            vis = np.clip(vi, 0, H - 1)
            zn = depth_maps[n][vis, uis]
            ok = (
                inb
                & valids[n][vis, uis]
                & (np.abs(zn - z) <= rel_tolerance * np.maximum(z, 1e-9))
            )
            agree += ok.astype(np.int32)
            agree_px.append((n, ok, vis, uis))

        keep = agree >= min_views
        if not keep.any():
            continue
        out_pts.append(P[keep])
        out_nrm.append(Nrm[keep])
        if images_rgb is not None:
            out_col.append(images_rgb[r][ys[keep], xs[keep]])
        # consume agreeing pixels in other views (dedup)
        for n, ok, vis, uis in agree_px:
            sel = ok & keep
            consumed[n][vis[sel], uis[sel]] = True
        log(f"view {r}: fused {int(keep.sum())}/{len(P)} pixels")

    if not out_pts:
        return {
            "points": np.zeros((0, 3)),
            "normals": np.zeros((0, 3)),
            "colors": np.zeros((0, 3), np.uint8),
        }
    return {
        "points": np.concatenate(out_pts),
        "normals": np.concatenate(out_nrm),
        "colors": (
            np.concatenate(out_col)
            if out_col
            else np.zeros((sum(len(p) for p in out_pts), 3), np.uint8)
        ),
    }
