"""PatchMatch multi-view stereo: checkerboard propagation.

The reference's default dense path is openMVS PatchMatch
(ref: src/photogrammetrie/mvs/MVS.cpp:112-120 ``DenseReconstruction(0)``;
SURVEY.md §2.4). plane_sweep.py covers it with a dense sweep; this module is
the direct PatchMatch analogue, reformulated for XLA's static dataflow:

  * the per-pixel state is a CONTINUOUS inverse-depth map (no plane
    quantization) plus its current photometric cost
  * sequential spatial propagation becomes CHECKERBOARD propagation: all
    pixels of one parity consider their 4 neighbors' depths simultaneously
    (red/black Gauss-Seidel — the standard GPU PatchMatch schedule: each
    half-iteration is a dense, fully batched candidate evaluation, no
    data-dependent control flow)
  * random search becomes a fixed number of batched perturbation candidates
    with geometrically shrinking scale (classic PatchMatch halving)
  * every candidate map is scored in one shot: per-pixel warp into each
    neighbor (elementwise projective math + bilinear gather), ZNCC over a
    box window, aggregated as the mean of the best half of neighbors —
    identical scoring to plane_sweep.sweep_cost_volume, so the two methods
    are directly comparable and share filtering

Performance structure (an earlier formulation was gather-bound):

  * PARITY PACKING: a half-iteration only updates one checkerboard parity,
    so candidates are scored ONLY at active pixels. The active half of a
    (H, W) map packs densely into (H, W/2) (one column parity per row), so
    every gather and every elementwise op in the scoring path runs on half the
    pixels. Nothing is wasted on pixels whose state cannot change.
  * MEMOIZED WINDOW GATHERS: the ZNCC window needs neighbor samples at
    warp(p) + o for all (2r+1)^2 offsets o; each bilinear sample touches 4
    integer taps, but adjacent offsets SHARE taps — only (2r+2)^2 unique
    integer-shifted gathers exist per (pixel, neighbor). Issuing
    4 gathers per offset would take (196 for r=3); this one gathers each unique tap
    once (64 for r=3) and reconstructs all 49 bilinear samples from them
    with the shared per-pixel weights (the fractional warp offset is the
    same for every window tap — Gipuma-style fronto-parallel patch,
    translation approximation of the local warp).
  * per-pixel windows are kept (not plane_sweep's shared-warp box filters):
    the patch at pixel p must be scored under p's OWN depth hypothesis — a
    shared warp of a spatially-varying candidate map would pollute every
    window with neighboring (possibly random) hypotheses and destroy the
    selection signal PatchMatch needs.
  * ref-side window statistics (mean/variance and the 49 shifted ref maps
    the cross term needs) are candidate-invariant: computed once per parity
    and hoisted out of the iteration scan by XLA.

Net effect vs 4 gathers per offset: ~6x fewer gathered elements per
half-iteration (196 -> 64 taps, each on half the pixels) with bit-identical
scoring semantics.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from sfm_mvs_pipeline.models.cameras import intrinsics_to_K
from sfm_mvs_pipeline.ops.pose import aa_to_rotmat, relative_pose


def _ref_rays(h: int, w: int, K: jax.Array, dtype) -> jax.Array:
    """(3, H, W) unnormalized camera rays K^-1 [u, v, 1]."""
    ys, xs = jnp.meshgrid(
        jnp.arange(h, dtype=dtype), jnp.arange(w, dtype=dtype), indexing="ij"
    )
    pix = jnp.stack([xs, ys, jnp.ones_like(xs)], axis=0)  # (3, H, W)
    return jnp.einsum("ij,jhw->ihw", jnp.linalg.inv(K), pix)


def _shift_edge(img: jax.Array, dy: int, dx: int) -> jax.Array:
    """img shifted so out[y, x] = img[y+dy, x+dx], edge-replicated."""
    h, w = img.shape
    yy = jnp.clip(jnp.arange(h) + dy, 0, h - 1)
    xx = jnp.clip(jnp.arange(w) + dx, 0, w - 1)
    return img[yy][:, xx]


def _pack(x: jax.Array, parity: int) -> jax.Array:
    """Extract the checkerboard-active half of the trailing (H, W) plane.

    Active pixels of parity p are (y, x) with (y+x) % 2 == p — one column
    parity per row — so they pack densely into (..., H, W//2):
        out[..., y, k] = x[..., y, 2k + (p + y) % 2]
    W must be even (patchmatch_depth pads internally)."""
    *lead, h, w = x.shape
    x2 = x.reshape(*lead, h, w // 2, 2)
    off = ((jnp.arange(h) + parity) % 2).reshape(h, 1)
    return jnp.where(off == 0, x2[..., 0], x2[..., 1])


def _unpack_update(full: jax.Array, vals: jax.Array, parity: int) -> jax.Array:
    """Scatter packed (H, W//2) values back into the active slots of full."""
    h, w = full.shape
    f2 = full.reshape(h, w // 2, 2)
    off = ((jnp.arange(h) + parity) % 2).reshape(h, 1)
    n0 = jnp.where(off == 0, vals, f2[..., 0])
    n1 = jnp.where(off == 1, vals, f2[..., 1])
    return jnp.stack([n0, n1], axis=-1).reshape(h, w)


def _parity_consts(ref_img: jax.Array, rays: jax.Array, parity: int, r: int):
    """Candidate-invariant per-parity scoring inputs: packed rays, packed
    ref window shifts, and the ref window mean/variance."""
    area = (2 * r + 1) ** 2
    ref_sh = [
        _pack(_shift_edge(ref_img, dy, dx), parity)
        for dy in range(-r, r + 1)
        for dx in range(-r, r + 1)
    ]
    sr = functools.reduce(jnp.add, ref_sh)
    srr = functools.reduce(jnp.add, [x * x for x in ref_sh])
    r_mean = sr / area
    r_var = jnp.maximum(srr / area - r_mean * r_mean, 1e-8)
    return {
        "rays": _pack(rays, parity),  # (3, H, W2)
        "ref_sh": ref_sh,  # 49 x (H, W2)
        "r_mean": r_mean,
        "r_var": r_var,
    }


def _cost_packed(
    inv_act: jax.Array,  # (H, W2) candidate inverse depth at active pixels
    consts: dict,
    nbr_imgs: jax.Array,  # (N, Hp, Wp) (padded to even width)
    rels: jax.Array,  # (N, 6)
    K: jax.Array,
    nbr_valid: jax.Array,  # (N,) bool
    window_radius: int,
    real_hw: tuple[int, int],
) -> jax.Array:
    """Photometric cost (H, W2) of one packed inverse-depth hypothesis.

    Mean over the best half of valid neighbors of (1 - ZNCC)/2; out-of-view
    samples cost 1."""
    r = window_radius
    area = (2 * r + 1) ** 2
    h_real, w_real = real_hw
    hp, wp = nbr_imgs.shape[-2:]
    depth = 1.0 / jnp.maximum(inv_act, 1e-9)
    X = consts["rays"] * depth[None]  # (3, H, W2) ref-frame points

    def per_neighbor(nbr_img, rel):
        R = aa_to_rotmat(rel[:3])
        t = rel[3:]
        Xn = jnp.einsum("ij,jhw->ihw", R, X) + t[:, None, None]
        p = jnp.einsum("ij,jhw->ihw", K, Xn)
        z = jnp.where(jnp.abs(p[2]) < 1e-9, 1e-9, p[2])
        xq = p[0] / z
        yq = p[1] / z
        inside = (
            (xq >= 0) & (xq <= w_real - 1.001)
            & (yq >= 0) & (yq <= h_real - 1.001)
            & (p[2] > 1e-6)
        )
        x0 = jnp.floor(xq)
        y0 = jnp.floor(yq)
        fx = xq - x0
        fy = yq - y0
        x0i = x0.astype(jnp.int32)
        y0i = y0.astype(jnp.int32)
        w00 = (1 - fx) * (1 - fy)
        w01 = fx * (1 - fy)
        w10 = (1 - fx) * fy
        w11 = fx * fy
        flat = nbr_img.reshape(-1)

        # unique integer taps: (2r+2)^2 gathers shared by all 49 offsets
        G = {}
        for dy in range(-r, r + 2):
            yy = jnp.clip(y0i + dy, 0, hp - 1) * wp
            for dx in range(-r, r + 2):
                xx = jnp.clip(x0i + dx, 0, wp - 1)
                G[(dy, dx)] = flat[(yy + xx).reshape(-1)].reshape(x0i.shape)

        sn = jnp.zeros_like(inv_act)
        snn = jnp.zeros_like(inv_act)
        srn = jnp.zeros_like(inv_act)
        o = 0
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                s_o = (
                    w00 * G[(dy, dx)] + w01 * G[(dy, dx + 1)]
                    + w10 * G[(dy + 1, dx)] + w11 * G[(dy + 1, dx + 1)]
                )
                sn = sn + s_o
                snn = snn + s_o * s_o
                srn = srn + consts["ref_sh"][o] * s_o
                o += 1
        n_mean = sn / area
        n_var = jnp.maximum(snn / area - n_mean * n_mean, 1e-8)
        cov = srn / area - consts["r_mean"] * n_mean
        zncc = cov / jnp.sqrt(consts["r_var"] * n_var)
        cost = (1.0 - jnp.clip(zncc, -1.0, 1.0)) * 0.5
        return jnp.where(inside, cost, 1.0)

    costs = jax.vmap(per_neighbor)(nbr_imgs, rels)  # (N, H, W2)
    n = costs.shape[0]
    costs = jnp.where(nbr_valid[:, None, None], costs, 1.0)
    srt = jnp.sort(jnp.moveaxis(costs, 0, -1), axis=-1)  # (H, W2, N) asc
    n_valid = jnp.sum(nbr_valid.astype(costs.dtype))
    k_dyn = jnp.maximum(jnp.ceil(n_valid / 2.0), 1.0)
    take = (jnp.arange(n, dtype=costs.dtype) < k_dyn).astype(costs.dtype)
    return jnp.einsum("hwn,n->hw", srt, take) / k_dyn


@functools.partial(
    jax.jit, static_argnames=("iterations", "window_radius")
)
def patchmatch_depth(
    ref_img: jax.Array,  # (H, W) grayscale f32
    nbr_imgs: jax.Array,  # (N, H, W)
    pose_r: jax.Array,  # (6,)
    poses_n: jax.Array,  # (N, 6)
    intr: jax.Array,  # (7,) intrinsics scaled to this resolution
    z_min: float | jax.Array,
    z_max: float | jax.Array,
    key: jax.Array,
    init_depth: jax.Array | None = None,  # (H, W) seed (e.g. coarser level)
    init_valid: jax.Array | None = None,  # (H, W) bool for the seed
    iterations: int = 8,
    window_radius: int = 3,
    max_cost: float = 0.4,
    nbr_valid: jax.Array | None = None,  # (N,) bool — False = padded slot
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """PatchMatch depth for one reference view.

    Returns (depth (H, W), cost (H, W), valid (H, W)) — the same contract
    as plane_sweep.wta_depth so mvs/pipeline.py can swap methods freely.
    """
    h, w = ref_img.shape
    dt = ref_img.dtype
    # parity packing needs an even width; pad with the edge column (the
    # padded column is sliced away from every output below)
    wp = w + (w % 2)
    if wp != w:
        ref_img = jnp.pad(ref_img, ((0, 0), (0, 1)), mode="edge")
        nbr_imgs = jnp.pad(nbr_imgs, ((0, 0), (0, 0), (0, 1)), mode="edge")
        if init_depth is not None:
            init_depth = jnp.pad(init_depth, ((0, 0), (0, 1)), mode="edge")
        if init_valid is not None:
            init_valid = jnp.pad(init_valid, ((0, 0), (0, 1)), mode="edge")
    K = intrinsics_to_K(intr).astype(dt)
    rays = _ref_rays(h, wp, K, dt)
    rels = jax.vmap(lambda pn: relative_pose(pose_r, pn))(poses_n)
    if nbr_valid is None:
        nbr_valid = jnp.ones(nbr_imgs.shape[0], bool)

    inv_lo = 1.0 / jnp.asarray(z_max, dt)
    inv_hi = 1.0 / jnp.asarray(z_min, dt)
    span = inv_hi - inv_lo

    r = window_radius
    consts = [_parity_consts(ref_img, rays, p, r) for p in (0, 1)]
    cost_of = [
        functools.partial(
            _cost_packed,
            consts=consts[p], nbr_imgs=nbr_imgs, rels=rels, K=K,
            nbr_valid=nbr_valid, window_radius=r, real_hw=(h, w),
        )
        for p in (0, 1)
    ]

    key, k0 = jax.random.split(key)
    inv = inv_lo + span * jax.random.uniform(k0, (h, wp), dt)
    if init_depth is not None:
        seed_inv = 1.0 / jnp.maximum(init_depth.astype(dt), 1e-9)
        seed_ok = (
            jnp.isfinite(seed_inv)
            & (seed_inv >= inv_lo) & (seed_inv <= inv_hi)
            & (jnp.ones((h, wp), bool) if init_valid is None else init_valid)
        )
        inv = jnp.where(seed_ok, seed_inv, inv)
    cost = jnp.zeros((h, wp), dt)
    for p in (0, 1):
        cost = _unpack_update(cost, cost_of[p](_pack(inv, p)), p)

    def half_iter(inv, cost, parity, it, k):
        """Update one checkerboard parity: score 6 candidates at the
        active pixels only (packed (H, W/2) layout) and keep improvements."""
        inv_act = _pack(inv, parity)
        cost_act = _pack(cost, parity)
        # propagation candidates: the 4 neighbors' depths (edge-replicated
        # shifts — border pixels see their edge neighbor, not a wrap-around)
        props = [
            _pack(_shift_edge(inv, -1, 0), parity),
            _pack(_shift_edge(inv, 1, 0), parity),
            _pack(_shift_edge(inv, 0, -1), parity),
            _pack(_shift_edge(inv, 0, 1), parity),
        ]
        # random search: geometric shrink of the search window + full-range
        scale = span * (0.5 ** (it.astype(dt) + 1.0))
        k1, k2 = jax.random.split(k)
        shp = inv_act.shape
        rand_local = inv_act + scale * (
            2.0 * jax.random.uniform(k1, shp, dt) - 1.0
        )
        rand_full = inv_lo + span * jax.random.uniform(k2, shp, dt)
        cands = jnp.stack(props + [rand_local, rand_full])  # (C, H, W2)
        cands = jnp.clip(cands, inv_lo, inv_hi)

        ccosts = jax.lax.map(cost_of[parity], cands)  # (C, H, W2)
        ci = jnp.argmin(ccosts, axis=0)
        cbest = jnp.take_along_axis(ccosts, ci[None], axis=0)[0]
        cinv = jnp.take_along_axis(cands, ci[None], axis=0)[0]
        better = cbest < cost_act
        inv = _unpack_update(inv, jnp.where(better, cinv, inv_act), parity)
        cost = _unpack_update(cost, jnp.where(better, cbest, cost_act), parity)
        return inv, cost

    def body(carry, inputs):
        inv, cost = carry
        it, k = inputs
        ka, kb = jax.random.split(k)
        inv, cost = half_iter(inv, cost, 0, it, ka)
        inv, cost = half_iter(inv, cost, 1, it, kb)
        return (inv, cost), None

    its = jnp.arange(iterations, dtype=jnp.int32)
    keys = jax.random.split(key, iterations)
    (inv, cost), _ = jax.lax.scan(body, (inv, cost), (its, keys))

    depth = 1.0 / jnp.maximum(inv, 1e-9)
    valid = cost <= max_cost
    return depth[:, :w], cost[:, :w], valid[:, :w]
