"""Synthetic multi-view renderer with exact ground-truth poses.

Pure numpy ray-casting of a parallax-rich two-plane scene (no pipeline code
involved), used by the oracle-free trajectory acceptance test
(tests/test_synthetic_gt.py) and by the head-to-head wall-clock bench
(bench_suite/headtohead.py). The renderer IS the ground truth: every view's
(R, C) is returned exactly, so trajectory error needs no external oracle.
"""

from __future__ import annotations

import os

import numpy as np


def render_views(
    out_dir,
    n_views: int = 8,
    h: int = 240,
    w: int = 320,
    f: float = 280.0,
    seed: int = 11,
    texture_path: str | None = None,
    planar: bool = False,
    detail: int = 1,
):
    """Render n_views PNGs of a textured two-plane scene into out_dir.

    planar=True drops the foreground disc, leaving a SINGLE plane — the
    degenerate regime for 8-point essential estimation (and for DLT PnP
    against the resulting coplanar map), used to regression-test the
    E-vs-H model selection + planar PnP family (ops/epipolar.py,
    ops/pnp.py).

    Cameras yaw by 0.05 rad/view around a lateral track (the geometry the
    incremental SfM + BA stack must recover). Returns (paths, gt_R (V,3,3)
    world->cam, gt_C (V,3) camera centers).

    texture_path: surface the scene with a REAL photograph instead of the
    procedural noise textures — the closest attainable stand-in for a real
    multi-view capture in a zero-egress environment (real radiometry and
    texture statistics, synthetic geometry with exact ground truth).

    detail: texels per world unit, as a multiple of the default. The
    procedural textures grow with it (side 1024 * detail), so the pattern
    repeats at the same world period while a high-resolution camera still
    sees about one texel per pixel and detects features at the density of
    a real capture."""
    from scipy.ndimage import gaussian_filter

    from sfm_mvs_pipeline.utils.images import (
        read_image,
        resize_area,
        rgb_to_gray,
        write_png,
    )

    rng = np.random.default_rng(seed)
    if texture_path is not None:
        if not os.path.exists(texture_path):
            raise FileNotFoundError(f"texture not found: {texture_path}")
        photo = read_image(texture_path)
        if photo.ndim == 3:
            photo = rgb_to_gray(photo)
        photo = resize_area(photo, (1024, 1024)).astype(np.float32) / 255.0
        tex = photo
        tex2 = np.rot90(photo).copy()
    else:
        side = 1024 * detail
        # mode="mirror" is OpenCV's default BORDER_REFLECT_101
        tex = gaussian_filter(
            rng.random((side, side)).astype(np.float32), 3.0, mode="mirror"
        )
        tex = (tex - tex.min()) / (tex.max() - tex.min())
        tex2 = gaussian_filter(
            rng.random((side, side)).astype(np.float32), 2.0, mode="mirror"
        )
        tex2 = (tex2 - tex2.min()) / (tex2.max() - tex2.min())
    gt_R, gt_C, paths = [], [], []
    os.makedirs(out_dir, exist_ok=True)
    for v in range(n_views):
        ang = (v - n_views / 2) * 0.05
        R = np.array(
            [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
             [-np.sin(ang), 0, np.cos(ang)]]
        )
        C = np.array([0.5 * v, 0.03 * v, 0.0])
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        d = np.stack(
            [(xs - w / 2) / f, (ys - h / 2) / f, np.ones_like(xs, np.float64)],
            -1,
        ) @ R  # world-frame rays of camera v (R is world->cam, rows = axes)
        img = np.zeros((h, w), np.float32)
        layers = (
            ((10.0, tex, 55.0),)
            if planar
            else ((10.0, tex, 55.0), (7.0, tex2, 75.0))
        )
        for z, t, scale in layers:
            n = t.shape[0]
            scale = scale * n / 1024
            s = (z - C[2]) / d[..., 2]
            Xw = C[None, None] + s[..., None] * d
            u = ((Xw[..., 0] * scale) % n).astype(int) % n
            vv = ((Xw[..., 1] * scale) % n).astype(int) % n
            layer = t[vv, u]
            if z == 7.0:
                mask = ((Xw[..., 0] - 2.0) ** 2 + Xw[..., 1] ** 2) < 4.0
                img = np.where(mask, layer, img)
            else:
                img = layer
        p = os.path.join(str(out_dir), f"{v:02d}.png")
        write_png(p, (img * 255).astype(np.uint8))
        paths.append(p)
        gt_R.append(R)
        gt_C.append(C)
    return paths, np.asarray(gt_R), np.asarray(gt_C)
