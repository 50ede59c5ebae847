"""Batched ORB feature detection + binary description in pure JAX.

Replacement for the reference's cv::ORB::create(featureLimit) frontend
(ref: src/cli/PhotogrammetrieCli.cpp:352-357) with the same structure:
FAST-9 corners on an image pyramid (scale 1.2, 8 levels), Harris-response
ranking, intensity-centroid orientation, and a 256-bit rotated-BRIEF
descriptor. The descriptor bit pattern is a DETERMINISTIC seeded Gaussian
pattern (classic BRIEF construction) — it only has to agree with itself
across images, not with OpenCV's learned pattern; matching quality is the
acceptance test.

Descriptors are returned as packed uint8 (F, 32); expand with
ops.matching.expand_binary_descriptors to match with a matrix product via
the Hamming-as-matmul identity.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from sfm_mvs_pipeline.ops.topk import select_top_k
import numpy as np

# FAST circle of radius 3 (the standard 16-pixel Bresenham ring)
_FAST_RING = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)  # (dx, dy)

N_BITS = 256
_PATCH = 31


def _brief_pattern(seed: int = 1234) -> np.ndarray:
    """(256, 4) sampling pattern (x1, y1, x2, y2), Gaussian sigma = patch/5."""
    rng = np.random.default_rng(seed)
    sigma = _PATCH / 5.0
    pts = rng.normal(0.0, sigma, size=(N_BITS, 4))
    lim = _PATCH // 2 - 1
    return np.clip(pts, -lim, lim).astype(np.float32)


_PATTERN = _brief_pattern()


def _shift2d(img: jax.Array, dx: int, dy: int) -> jax.Array:
    """Shift with edge clamp: out[y, x] = img[y+dy, x+dx]."""
    return jnp.roll(img, shift=(-dy, -dx), axis=(-2, -1))


def fast_score(img: jax.Array, threshold: float = 0.08) -> jax.Array:
    """FAST-9 corner mask+score for (..., H, W) images in [0, 1].

    A pixel is a corner if >= 9 contiguous ring pixels are all brighter than
    c + t or all darker than c - t. Score = Harris-like corner response used
    for ranking (cv ORB's HARRIS_SCORE choice).
    """
    ring = [
        _shift2d(img, int(dx), int(dy)) for dx, dy in _FAST_RING
    ]  # 16 x (..., H, W)
    ring = jnp.stack(ring, axis=0)
    bright = ring > (img + threshold)[None]
    dark = ring < (img - threshold)[None]

    def arc9(mask):
        # any window of 9 contiguous (circular) positions all true
        acc = jnp.zeros_like(mask[0], dtype=bool)
        for start in range(16):
            win = mask[(np.arange(start, start + 9) % 16)]
            acc = acc | jnp.all(win, axis=0)
        return acc

    is_corner = arc9(bright) | arc9(dark)

    # Harris response for ranking
    dx = (_shift2d(img, 1, 0) - _shift2d(img, -1, 0)) * 0.5
    dy = (_shift2d(img, 0, 1) - _shift2d(img, 0, -1)) * 0.5
    from sfm_mvs_pipeline.ops.sift import gaussian_blur

    # blur of products over a small window
    def smooth(x):
        shape = x.shape
        flat = x.reshape((-1,) + shape[-2:])
        return gaussian_blur(flat, 1.5).reshape(shape)

    a = smooth(dx * dx)
    b = smooth(dy * dy)
    c = smooth(dx * dy)
    det = a * b - c * c
    tr = a + b
    harris = det - 0.04 * tr * tr
    return jnp.where(is_corner, harris, -jnp.inf)


def _nms3x3(score: jax.Array) -> jax.Array:
    mx = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (1, 3, 3), (1, 1, 1), "SAME"
    )
    return jnp.where(score >= mx, score, -jnp.inf)


@functools.partial(
    jax.jit, static_argnames=("max_features", "n_levels", "threshold")
)
def orb_features(
    images: jax.Array,  # (B, H, W) float [0,1] or uint8
    max_features: int = 2048,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    threshold: float = 0.08,
) -> dict:
    """Full batched ORB. Returns dict with keypoints (B,F,2), angle,
    response, scale, valid (B,F), descriptors (B,F,32) packed uint8."""
    if images.dtype == jnp.uint8:
        images = images.astype(jnp.float32) / 255.0
    b, h, w = images.shape
    border = _PATCH // 2 + 2

    per_level = []
    cur = images
    for lev in range(n_levels):
        hl, wl = cur.shape[-2:]
        if min(hl, wl) < 2 * border + 8:
            break
        smoothed = cur
        score = _nms3x3(fast_score(smoothed, threshold))
        # mask borders via iota comparisons
        yy = jax.lax.broadcasted_iota(jnp.int32, (hl, wl), 0)
        xx = jax.lax.broadcasted_iota(jnp.int32, (hl, wl), 1)
        inb = (
            (yy >= border) & (yy < hl - border) & (xx >= border) & (xx < wl - border)
        )
        score = jnp.where(inb[None], score, -jnp.inf)

        k_lev = max(max_features // max(1, lev + 1), 64)
        k_lev = min(k_lev, hl * wl)
        vals, idx = select_top_k(score.reshape(b, -1), k_lev)
        ys = (idx // wl).astype(jnp.float32)
        xs = (idx % wl).astype(jnp.float32)
        valid = jnp.isfinite(vals)

        # orientation: intensity centroid over a circular patch (r = 15)
        r_pat = 15
        lin = jnp.arange(-r_pat, r_pat + 1, dtype=jnp.float32)
        gy, gx = jnp.meshgrid(lin, lin, indexing="ij")
        circ = (gx * gx + gy * gy) <= r_pat * r_pat

        from sfm_mvs_pipeline.ops.sift import _bilinear

        def per_image_ori(im, x0, y0):
            sx = x0[:, None, None] + gx[None]
            sy = y0[:, None, None] + gy[None]
            v = _bilinear(im, sx, sy) * circ[None]
            m10 = jnp.sum(v * gx[None], axis=(1, 2))
            m01 = jnp.sum(v * gy[None], axis=(1, 2))
            return jnp.arctan2(m01, m10)

        ang = jax.vmap(per_image_ori)(smoothed, xs, ys)

        # rBRIEF on a blurred level (classic BRIEF smoothing)
        from sfm_mvs_pipeline.ops.sift import gaussian_blur

        blurred = gaussian_blur(smoothed, 2.0)
        pat = jnp.asarray(_PATTERN)

        def per_image_desc(im, x0, y0, a0):
            ca = jnp.cos(a0)[:, None]
            sa = jnp.sin(a0)[:, None]
            x1 = ca * pat[None, :, 0] - sa * pat[None, :, 1] + x0[:, None]
            y1 = sa * pat[None, :, 0] + ca * pat[None, :, 1] + y0[:, None]
            x2 = ca * pat[None, :, 2] - sa * pat[None, :, 3] + x0[:, None]
            y2 = sa * pat[None, :, 2] + ca * pat[None, :, 3] + y0[:, None]
            v1 = _bilinear(im, x1, y1)
            v2 = _bilinear(im, x2, y2)
            return (v1 < v2).astype(jnp.uint8)  # (K, 256)

        bits = jax.vmap(per_image_desc)(blurred, xs, ys, ang)

        lvl_scale = scale_factor**lev
        per_level.append(
            {
                "keypoints": jnp.stack([xs, ys], axis=-1) * lvl_scale,
                "angle": ang,
                "response": jnp.where(valid, vals, -jnp.inf),
                "scale": jnp.full_like(ang, lvl_scale),
                "valid": valid,
                "bits": bits,
            }
        )
        # next pyramid level
        nh = int(round(cur.shape[-2] / scale_factor))
        nw = int(round(cur.shape[-1] / scale_factor))
        cur = jax.image.resize(cur, (b, nh, nw), method="linear")

    merged = {
        k: jnp.concatenate([p[k] for p in per_level], axis=1)
        for k in per_level[0]
    }
    score = jnp.where(merged["valid"], merged["response"], -jnp.inf)
    _, top = select_top_k(score, max_features)
    take = lambda a: jnp.take_along_axis(
        a, top.reshape(b, -1, *([1] * (a.ndim - 2))), axis=1
    )
    bits = take(merged["bits"])  # (B, F, 256)
    packed = jnp.packbits(bits, axis=-1, bitorder="little")  # (B, F, 32)
    return {
        "keypoints": take(merged["keypoints"]),
        "angle": jnp.take_along_axis(merged["angle"], top, axis=1),
        "response": jnp.take_along_axis(merged["response"], top, axis=1),
        "scale": jnp.take_along_axis(merged["scale"], top, axis=1),
        "valid": jnp.take_along_axis(merged["valid"], top, axis=1)
        & jnp.isfinite(jnp.take_along_axis(score, top, axis=1)),
        "descriptors": packed,
    }
