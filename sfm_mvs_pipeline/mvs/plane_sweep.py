"""Plane-sweep stereo: multi-view cost volumes + WTA depth maps.

A dense replacement for openMVS's PatchMatch densification default
(ref: src/photogrammetrie/mvs/MVS.cpp:112-120 `DenseReconstruction(0)`).
PatchMatch's sequential spatial propagation maps poorly onto XLA; the
equivalent-quality array formulation is a dense plane sweep: every
depth hypothesis is evaluated for every pixel in parallel (propagation
becomes a dense argmin over the hypothesis axis),
followed by sub-pixel parabola refinement and photometric/consistency
filtering. SGM (mvs/sgm.py) optionally regularizes the same cost volume —
mirroring the reference's --sgm path (MVS.cpp:113-116).

Geometry: for reference view r and neighbor n, a fronto-parallel plane at
depth d induces the homography
    H_n(d) = K_n (R_rel - t_rel [0,0,1]/d) K_r^-1
Pixels of r are warped into n via H_n(d) and compared with ZNCC over a
box window (separable box sums — cheap convs).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from sfm_mvs_pipeline.models.cameras import intrinsics_to_K
from sfm_mvs_pipeline.ops.pose import aa_to_rotmat, relative_pose


def _box_filter(x: jax.Array, radius: int) -> jax.Array:
    """Separable box sum over the last two axes (same-size, edge-padded)."""
    k = 2 * radius + 1
    x = jnp.cumsum(jnp.pad(x, [(0, 0)] * (x.ndim - 2) + [(radius + 1, radius), (0, 0)], mode="edge"), axis=-2)
    x = x[..., k:, :] - x[..., :-k, :]
    x = jnp.cumsum(jnp.pad(x, [(0, 0)] * (x.ndim - 2) + [(0, 0), (radius + 1, radius)], mode="edge"), axis=-1)
    x = x[..., :, k:] - x[..., :, :-k]
    return x


def _bilinear_hw(img: jax.Array, x: jax.Array, y: jax.Array):
    """Bilinear sample img (H, W) at float coords; returns (vals, inside).

    Taps are FLAT-indexed gathers (y*W+x into the raveled image), one 1-D
    gather per tap instead of 2-D fancy indexing; gathers are the cost of
    every warp in the dense stack."""
    h, w = img.shape
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    inside = (x >= 0) & (x <= w - 1.001) & (y >= 0) & (y <= h - 1.001)
    flat = img.reshape(-1)

    def at(yy, xx):
        lin = jnp.clip(yy, 0, h - 1) * w + jnp.clip(xx, 0, w - 1)
        return flat[lin.reshape(-1)].reshape(x.shape)

    v = (
        at(y0i, x0i) * (1 - fx) * (1 - fy)
        + at(y0i, x0i + 1) * fx * (1 - fy)
        + at(y0i + 1, x0i) * (1 - fx) * fy
        + at(y0i + 1, x0i + 1) * fx * fy
    )
    return v, inside


def plane_homographies(
    pose_r: jax.Array, pose_n: jax.Array, K_r: jax.Array, K_n: jax.Array,
    depths: jax.Array,
) -> jax.Array:
    """(D, 3, 3) homographies ref->neighbor for fronto-parallel planes."""
    rel = relative_pose(pose_r, pose_n)
    R = aa_to_rotmat(rel[:3])
    t = rel[3:]
    n_vec = jnp.array([0.0, 0.0, 1.0], dtype=pose_r.dtype)
    Kr_inv = jnp.linalg.inv(K_r)
    # plane n.X = d in the ref frame; X_n = R X_r + t = (R + t n^T / d) X_r
    H = (
        R[None, :, :]
        + t[None, :, None] * n_vec[None, None, :] / depths[:, None, None]
    )
    return K_n[None] @ H @ Kr_inv[None]


@functools.partial(jax.jit, static_argnames=("window_radius",))
def sweep_cost_volume(
    ref_img: jax.Array,  # (H, W) grayscale f32
    nbr_imgs: jax.Array,  # (N, H, W)
    pose_r: jax.Array,
    poses_n: jax.Array,  # (N, 6)
    intr: jax.Array,  # (7,) shared intrinsics (scaled to this resolution)
    depths: jax.Array,  # (D,) plane depths
    window_radius: int = 3,
    nbr_valid: jax.Array | None = None,  # (N,) bool — False = padded slot
) -> jax.Array:
    """Cost volume (D, H, W): mean over neighbors of (1 - ZNCC)/2 in [0, 1].

    Out-of-view samples cost 1 (worst). ZNCC window = (2r+1)^2 box.

    nbr_valid enables FIXED-CAPACITY neighbor lists (needed by the
    view-sharded path, parallel/mvs.py, where every view must have the same
    shapes): padded slots cost 1 everywhere and the best-half aggregation
    counts only valid neighbors.
    """
    h, w = ref_img.shape
    K = intrinsics_to_K(intr)
    ys, xs = jnp.meshgrid(
        jnp.arange(h, dtype=ref_img.dtype), jnp.arange(w, dtype=ref_img.dtype),
        indexing="ij",
    )
    ones = jnp.ones_like(xs)
    pix = jnp.stack([xs, ys, ones], axis=0).reshape(3, -1)  # (3, HW)

    area = (2 * window_radius + 1) ** 2
    r_sum = _box_filter(ref_img, window_radius)
    r_sq = _box_filter(ref_img * ref_img, window_radius)
    r_mean = r_sum / area
    r_var = jnp.maximum(r_sq / area - r_mean * r_mean, 1e-8)

    def per_neighbor(nbr_img, pose_n):
        Hs = plane_homographies(pose_r, pose_n, K, K, depths)  # (D, 3, 3)

        def per_depth(Hd):
            q = Hd @ pix  # (3, HW)
            zq = q[2]
            zq = jnp.where(jnp.abs(zq) < 1e-9, 1e-9, zq)
            xq = (q[0] / zq).reshape(h, w)
            yq = (q[1] / zq).reshape(h, w)
            warped, inside = _bilinear_hw(nbr_img, xq, yq)
            # ZNCC against ref over the window
            w_sum = _box_filter(warped, window_radius)
            w_sq = _box_filter(warped * warped, window_radius)
            rw = _box_filter(ref_img * warped, window_radius)
            w_mean = w_sum / area
            w_var = jnp.maximum(w_sq / area - w_mean * w_mean, 1e-8)
            cov = rw / area - r_mean * w_mean
            zncc = cov / jnp.sqrt(r_var * w_var)
            cost = (1.0 - jnp.clip(zncc, -1.0, 1.0)) * 0.5
            return jnp.where(inside, cost, 1.0)

        return jax.lax.map(per_depth, Hs)  # (D, H, W)

    costs = jax.vmap(per_neighbor)(nbr_imgs, poses_n)  # (N, D, H, W)
    n = costs.shape[0]
    if nbr_valid is None:
        # robust aggregation: mean of the best half of neighbors per (d, px)
        k = max(1, (n + 1) // 2)
        best = -jax.lax.top_k(-jnp.moveaxis(costs, 0, -1), k)[0]  # (D, H, W, k)
        return jnp.mean(best, axis=-1)
    # masked variant: padded neighbors cost 1 (sort last); take the best
    # ceil(n_valid/2) by position after an ascending sort along N
    costs = jnp.where(nbr_valid[:, None, None, None], costs, 1.0)
    srt = jnp.sort(jnp.moveaxis(costs, 0, -1), axis=-1)  # (D, H, W, N) asc
    n_valid = jnp.sum(nbr_valid.astype(costs.dtype))
    k_dyn = jnp.maximum(jnp.ceil(n_valid / 2.0), 1.0)
    take = (jnp.arange(n, dtype=costs.dtype) < k_dyn).astype(costs.dtype)
    return jnp.einsum("dhwn,n->dhw", srt, take) / k_dyn


@jax.jit
def wta_depth(
    cost_volume: jax.Array,  # (D, H, W)
    depths: jax.Array,  # (D,)
    max_cost: float | jax.Array = 0.4,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Winner-take-all depth + parabola sub-hypothesis refinement.

    Returns (depth (H, W), cost (H, W), valid (H, W)). Refinement
    interpolates in INVERSE depth (planes are sampled uniformly there).
    """
    d_idx = jnp.argmin(cost_volume, axis=0)  # (H, W)
    dmax = cost_volume.shape[0] - 1
    cmin = jnp.min(cost_volume, axis=0)

    def at(idx):
        return jnp.take_along_axis(
            cost_volume, jnp.clip(idx, 0, dmax)[None], axis=0
        )[0]

    c0 = at(d_idx - 1)
    c1 = cmin
    c2 = at(d_idx + 1)
    denom = c0 - 2 * c1 + c2
    delta = jnp.where(jnp.abs(denom) > 1e-12, 0.5 * (c0 - c2) / denom, 0.0)
    delta = jnp.clip(delta, -0.5, 0.5)
    # interpolate in inverse depth
    inv_d = 1.0 / depths
    i0 = inv_d[jnp.clip(d_idx - 1, 0, dmax)]
    i1 = inv_d[d_idx]
    i2 = inv_d[jnp.clip(d_idx + 1, 0, dmax)]
    inv = jnp.where(delta >= 0, i1 + delta * (i2 - i1), i1 - delta * (i0 - i1))
    depth = 1.0 / jnp.maximum(inv, 1e-9)
    interior = (d_idx > 0) & (d_idx < dmax)
    valid = (c1 <= max_cost) & interior
    return depth, c1, valid


def make_depth_planes(z_min: float, z_max: float, n: int) -> np.ndarray:
    """Inverse-depth-uniform plane placement (standard plane sweep)."""
    return 1.0 / np.linspace(1.0 / z_max, 1.0 / z_min, n)
