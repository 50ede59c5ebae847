"""Batched SIFT feature detection + description in pure JAX.

Batched replacement for the reference's cv::SIFT::create(featureLimit, 3,
0.09) frontend (ref: src/cli/PhotogrammetrieCli.cpp:342-357 and the
per-image extraction loop SfM.cpp:577-597). Instead of per-image dynamic
keypoint lists, the whole batch of images runs through one jitted pipeline
with a fixed feature capacity F and validity masks:

  images (B, H, W) -> keypoints (B, F, 2), scale/angle/response (B, F),
                      valid (B, F), descriptors (B, F, 128)

Algorithm (standard Lowe SIFT, OpenCV-flavored):
  * optional 2x initial upsample (OpenCV firstOctave = -1)
  * Gaussian pyramid, nOctaveLayers=3, sigma0=1.6, k=2^(1/3); separable
    convs
  * DoG extrema via 3x3x3 reduce_window max/min, contrast prefilter
  * one-step 3D quadratic subpixel refinement (clamped), contrast + edge
    (Hessian-ratio, r=10) rejection
  * per-octave top-k by |response| into the fixed capacity, merged globally
  * orientation = dominant peak of a 36-bin Gaussian-weighted gradient
    histogram sampled on a scale-relative grid (bilinear gathers)
  * descriptor = classic 4x4 spatial x 8 orientation histogram from a
    rotated, scale-relative 16x16 sample grid; normalize -> clip 0.2 ->
    renormalize -> scale 512, round and saturate (OpenCV convention:
    integers in [0, 255])

Exact OpenCV-bit fidelity is NOT a goal (SURVEY.md §7 hard part (c)); the
acceptance test is downstream geometry quality. Everything is jit/vmap
friendly: static shapes, no data-dependent control flow.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from sfm_mvs_pipeline.ops.topk import select_top_k
import numpy as np


# ---------------------------------------------------------------- gaussians
def _gauss_kernel1d(sigma: float) -> np.ndarray:
    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: jax.Array, sigma: float) -> jax.Array:
    """Separable Gaussian blur. img: (B, H, W). sigma is a python float
    (static), so the kernel is a compile-time constant.

    Implemented as shift-and-accumulate over static slices of a padded
    buffer rather than conv_general_dilated: XLA lays the conv's
    singleton channel dim out MINORMOST and tiles it to 128 lanes, which
    pads a (1, 1, 3600, 6400) f32 intermediate 128x (88 MB -> 11 GB) and
    OOMs the 3200-px ladder. The shift-add form keeps W minormost and
    fuses into one elementwise pass per axis."""
    if sigma <= 0:
        return img
    k = _gauss_kernel1d(sigma)
    r = (len(k) - 1) // 2
    h, w = img.shape[-2:]
    p = jnp.pad(img, ((0, 0), (r, r), (0, 0)), mode="edge")
    out = None
    for i, ki in enumerate(k):
        term = p[:, i : i + h, :] * jnp.asarray(ki, img.dtype)
        out = term if out is None else out + term
    p = jnp.pad(out, ((0, 0), (0, 0), (r, r)), mode="edge")
    out = None
    for i, ki in enumerate(k):
        term = p[:, :, i : i + w] * jnp.asarray(ki, img.dtype)
        out = term if out is None else out + term
    return out


def _resize_half(img: jax.Array) -> jax.Array:
    return img[:, ::2, ::2]


def _resize_double(img: jax.Array) -> jax.Array:
    b, h, w = img.shape
    return jax.image.resize(img, (b, h * 2, w * 2), method="linear")


# ---------------------------------------------------------------- pyramid
def build_pyramid(
    img: jax.Array,
    n_octaves: int,
    n_layers: int = 3,
    sigma0: float = 1.6,
    upsample: bool = True,
    assumed_blur: float = 0.5,
):
    """Returns (gaussians, dogs): lists per octave of (B, L+3, Ho, Wo) /
    (B, L+2, Ho, Wo)."""
    if upsample:
        base = _resize_double(img)
        delta = math.sqrt(max(sigma0**2 - (2 * assumed_blur) ** 2, 0.01))
    else:
        base = img
        delta = math.sqrt(max(sigma0**2 - assumed_blur**2, 0.01))
    base = gaussian_blur(base, delta)

    k = 2.0 ** (1.0 / n_layers)
    # incremental blur amounts within an octave (OpenCV scheme)
    sig_prev = sigma0
    sig_incr = []
    for i in range(1, n_layers + 3):
        sig_total = sigma0 * (k**i)
        sig_incr.append(math.sqrt(sig_total**2 - sig_prev**2))
        sig_prev = sig_total

    gaussians, dogs = [], []
    cur = base
    for o in range(n_octaves):
        levels = [cur]
        g = cur
        for s in sig_incr:
            g = gaussian_blur(g, s)
            levels.append(g)
        G = jnp.stack(levels, axis=1)  # (B, L+3, H, W)
        gaussians.append(G)
        dogs.append(G[:, 1:] - G[:, :-1])
        # next octave base = level n_layers (sigma doubled), downsampled
        cur = _resize_half(levels[n_layers])
    return gaussians, dogs


# ---------------------------------------------------------------- extrema
def _find_octave_extrema(
    dog: jax.Array,  # (B, L+2, H, W)
    contrast_threshold: float,
    edge_threshold: float,
    n_layers: int,
    k_oct: int,
):
    """Detect + refine extrema in one octave.

    Returns dict of (B, k_oct) arrays: x, y (octave pixel coords, subpixel),
    layer (int, 1..L), offset_s (subpixel sigma offset), response, valid.
    """
    b, L2, h, w = dog.shape
    prefilter = 0.5 * contrast_threshold / n_layers

    big = jnp.asarray(1e9, dog.dtype)
    mx = jax.lax.reduce_window(
        dog, -big, jax.lax.max, (1, 3, 3, 3), (1, 1, 1, 1), "SAME"
    )
    mn = jax.lax.reduce_window(
        dog, big, jax.lax.min, (1, 3, 3, 3), (1, 1, 1, 1), "SAME"
    )
    is_ext = ((dog >= mx) | (dog <= mn)) & (jnp.abs(dog) > prefilter)
    # only middle layers, keep a border of 5 px (OpenCV SIFT_IMG_BORDER);
    # masks from iota comparisons (scatter-free: cheap to compile & run)
    li_ = jax.lax.broadcasted_iota(jnp.int32, (L2, 1, 1), 0)
    yi_ = jax.lax.broadcasted_iota(jnp.int32, (1, h, 1), 1)
    xi_ = jax.lax.broadcasted_iota(jnp.int32, (1, 1, w), 2)
    border = 5
    keep = (
        (li_ >= 1)
        & (li_ < L2 - 1)
        & (yi_ >= border)
        & (yi_ < h - border)
        & (xi_ >= border)
        & (xi_ < w - border)
    )
    is_ext = is_ext & keep[None]

    score = jnp.where(is_ext, jnp.abs(dog), 0.0)
    flat = score.reshape(b, -1)
    vals, idx = select_top_k(flat, k_oct)  # (B, k_oct)
    valid = vals > 0

    # unravel
    li = idx // (h * w)
    rem = idx % (h * w)
    yi = rem // w
    xi = rem % w

    # ---- quadratic refinement via finite differences at (li, yi, xi)
    def grab(dl, dy, dx):
        return dog[
            jnp.arange(b)[:, None],
            jnp.clip(li + dl, 0, L2 - 1),
            jnp.clip(yi + dy, 0, h - 1),
            jnp.clip(xi + dx, 0, w - 1),
        ]

    D = grab(0, 0, 0)
    dx_ = (grab(0, 0, 1) - grab(0, 0, -1)) * 0.5
    dy_ = (grab(0, 1, 0) - grab(0, -1, 0)) * 0.5
    ds_ = (grab(1, 0, 0) - grab(-1, 0, 0)) * 0.5
    dxx = grab(0, 0, 1) + grab(0, 0, -1) - 2 * D
    dyy = grab(0, 1, 0) + grab(0, -1, 0) - 2 * D
    dss = grab(1, 0, 0) + grab(-1, 0, 0) - 2 * D
    dxy = (grab(0, 1, 1) - grab(0, 1, -1) - grab(0, -1, 1) + grab(0, -1, -1)) * 0.25
    dxs = (grab(1, 0, 1) - grab(1, 0, -1) - grab(-1, 0, 1) + grab(-1, 0, -1)) * 0.25
    dys = (grab(1, 1, 0) - grab(1, -1, 0) - grab(-1, 1, 0) + grab(-1, -1, 0)) * 0.25

    H = jnp.stack(
        [
            jnp.stack([dxx, dxy, dxs], -1),
            jnp.stack([dxy, dyy, dys], -1),
            jnp.stack([dxs, dys, dss], -1),
        ],
        -2,
    )  # (B, K, 3, 3)
    g = jnp.stack([dx_, dy_, ds_], -1)  # (B, K, 3)
    # solve H off = -g with regularization for robustness
    Hr = H + 1e-6 * jnp.eye(3, dtype=dog.dtype)
    off = -jnp.linalg.solve(Hr, g[..., None])[..., 0]
    off = jnp.clip(off, -0.5, 0.5)

    contrast = D + 0.5 * jnp.sum(g * off, axis=-1)
    valid = valid & (jnp.abs(contrast) * n_layers >= contrast_threshold)

    # edge response on the 2x2 spatial Hessian
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_threshold
    valid = valid & (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)

    return {
        "x": xi.astype(dog.dtype) + off[..., 0],
        "y": yi.astype(dog.dtype) + off[..., 1],
        "layer": li,
        "off_s": off[..., 2],
        "response": jnp.abs(contrast),
        "valid": valid,
    }


# ------------------------------------------------------- orientation + desc
def _bilinear(img: jax.Array, x: jax.Array, y: jax.Array, lvl=None) -> jax.Array:
    """Bilinear sample. img: (H, W) or (nlev, H, W) with per-sample level
    indices `lvl` (broadcastable to x's shape). Zero padding outside."""
    h, w = img.shape[-2:]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    def at(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        yc = jnp.clip(yy, 0, h - 1)
        xc = jnp.clip(xx, 0, w - 1)
        if img.ndim == 3:
            v = img[jnp.broadcast_to(lvl, yc.shape), yc, xc]
        else:
            v = img[yc, xc]
        return jnp.where(inside, v, 0.0)

    return (
        at(y0i, x0i) * (1 - fx) * (1 - fy)
        + at(y0i, x0i + 1) * fx * (1 - fy)
        + at(y0i + 1, x0i) * (1 - fx) * fy
        + at(y0i + 1, x0i + 1) * fx * fy
    )


_ORI_GRID = 8  # samples per side for orientation histogram
_DESC_GRID = 16  # samples per side for descriptor
_N_ORI_BINS = 36


def _keypoint_orientation(samp, x, y, sigma_rel, dtype):
    """Dominant gradient orientation. samp(sx, sy) -> samples (K, S) from
    each keypoint's own (octave, level) plane; x, y, sigma_rel: (K,).
    Returns angle (K,) rad."""
    lin = jnp.arange(-_ORI_GRID, _ORI_GRID + 1, dtype=dtype)
    gy, gx = jnp.meshgrid(lin, lin, indexing="ij")  # (n, n)
    # flatten the sample grid so the (K, n*n) temporaries keep the long
    # axis minormost: one (K, 289) array instead of (K, 17, 17).
    gx = gx.ravel()
    gy = gy.ravel()  # (n*n,)
    # sample spacing: cover radius 3 * 1.5 * sigma
    step = (3.0 * 1.5) / _ORI_GRID * sigma_rel  # (K,)
    sx = x[:, None] + gx[None] * step[:, None]
    sy = y[:, None] + gy[None] * step[:, None]

    dxs = samp(sx + 1, sy) - samp(sx - 1, sy)
    dys = samp(sx, sy + 1) - samp(sx, sy - 1)
    mag = jnp.sqrt(dxs * dxs + dys * dys)
    theta = jnp.arctan2(dys, dxs)  # (K, n*n)

    r2 = (gx * gx + gy * gy)[None] / (_ORI_GRID / 2.0) ** 2
    wgt = jnp.exp(-r2) * mag

    bins = (theta / (2 * jnp.pi) * _N_ORI_BINS) % _N_ORI_BINS
    b0 = jnp.floor(bins).astype(jnp.int32) % _N_ORI_BINS
    f = bins - jnp.floor(bins)
    oh0 = jax.nn.one_hot(b0, _N_ORI_BINS, dtype=dtype) * ((1 - f) * wgt)[..., None]
    oh1 = jax.nn.one_hot((b0 + 1) % _N_ORI_BINS, _N_ORI_BINS, dtype=dtype) * (
        f * wgt
    )[..., None]
    hist = jnp.sum(oh0 + oh1, axis=1)  # (K, 36)
    # smooth histogram (circular [1 4 6 4 1]/16 like OpenCV, applied once)
    kern = jnp.asarray([1.0, 4.0, 6.0, 4.0, 1.0], dtype) / 16.0
    histp = jnp.concatenate([hist[:, -2:], hist, hist[:, :2]], axis=1)
    hist = jax.vmap(lambda hrow: jnp.convolve(hrow, kern, mode="valid"))(histp)

    def refine_angle(peak):
        # parabolic interpolation around a histogram peak
        hp = hist[jnp.arange(hist.shape[0]), (peak - 1) % _N_ORI_BINS]
        hc = hist[jnp.arange(hist.shape[0]), peak]
        hn = hist[jnp.arange(hist.shape[0]), (peak + 1) % _N_ORI_BINS]
        denom = hp - 2 * hc + hn
        delta = jnp.where(
            jnp.abs(denom) > 1e-12, 0.5 * (hp - hn) / denom, 0.0
        )
        ang_bin = peak.astype(dtype) + jnp.clip(delta, -0.5, 0.5)
        return (ang_bin / _N_ORI_BINS) * 2 * jnp.pi

    peak = jnp.argmax(hist, axis=1)
    hmax = jnp.max(hist, axis=1)
    # SECONDARY orientation (r5, OpenCV parity): every local histogram
    # maximum >= 0.8 * peak becomes an additional keypoint at the same
    # location (ref behavior via cv::SIFT; the strongest such secondary is
    # kept — fixed shapes cap the duplication at 2 orientations/candidate)
    left = jnp.roll(hist, 1, axis=1)
    right = jnp.roll(hist, -1, axis=1)
    bins_i = jnp.arange(_N_ORI_BINS)[None, :]
    is_peak = (hist > left) & (hist >= right) & (bins_i != peak[:, None])
    sec_score = jnp.where(
        is_peak & (hist >= 0.8 * hmax[:, None]), hist, -1.0
    )
    peak2 = jnp.argmax(sec_score, axis=1)
    has2 = jnp.max(sec_score, axis=1) > 0
    return refine_angle(peak), refine_angle(peak2), has2


def _keypoint_descriptor(samp, x, y, sigma_rel, angle, dtype):
    """Classic 4x4x8 SIFT descriptor. samp(sx, sy) -> (K, S) samples from
    each keypoint's own (octave, level) plane. Returns (K, 128)."""
    d = 4
    n = _DESC_GRID
    # sample grid in descriptor-bin units: [-d/2, d/2) with n samples/side
    lin = (jnp.arange(n, dtype=dtype) + 0.5) / n * d - d / 2.0  # bin units
    gy, gx = jnp.meshgrid(lin, lin, indexing="ij")  # (n, n)
    # flat (n*n,) grid: keeps the sample axis minormost (see
    # _keypoint_orientation) instead of a (K, 16, 16) layout.
    gx = gx.ravel()
    gy = gy.ravel()
    bin_w = 3.0 * sigma_rel  # pixels per descriptor bin (hist_width)

    ca = jnp.cos(angle)
    sa = jnp.sin(angle)
    # rotate grid by angle, scale to pixels
    px = (ca[:, None] * gx[None] - sa[:, None] * gy[None]) * bin_w[
        :, None
    ] + x[:, None]
    py = (sa[:, None] * gx[None] + ca[:, None] * gy[None]) * bin_w[
        :, None
    ] + y[:, None]

    dxs = samp(px + 1, py) - samp(px - 1, py)
    dys = samp(px, py + 1) - samp(px, py - 1)
    mag = jnp.sqrt(dxs * dxs + dys * dys)
    theta = jnp.arctan2(dys, dxs) - angle[:, None]

    # gaussian window over the whole descriptor (sigma = d/2 in bin units)
    r2 = (gx * gx + gy * gy)[None] / (2 * (d / 2.0) ** 2)
    wgt = jnp.exp(-r2) * mag  # (K, n*n)

    # spatial soft-binning: sample coords in bin space are (gx + d/2 - 0.5)
    bx = gx + d / 2.0 - 0.5  # [-0.5 .. 3.5]
    by = gy + d / 2.0 - 0.5
    x0 = jnp.floor(bx)
    y0 = jnp.floor(by)
    fx = bx - x0
    fy = by - y0

    def spatial_w(ix, iy):
        wx = jnp.where(ix == x0, 1 - fx, jnp.where(ix == x0 + 1, fx, 0.0))
        wy = jnp.where(iy == y0, 1 - fy, jnp.where(iy == y0 + 1, fy, 0.0))
        inx = (ix >= 0) & (ix < d)
        iny = (iy >= 0) & (iy < d)
        return jnp.where(inx & iny, wx * wy, 0.0)

    # (n*n, 16) static spatial weights
    Wsp = jnp.stack(
        [spatial_w(ix, iy) for iy in range(d) for ix in range(d)], axis=-1
    )

    # orientation soft binning (8 bins)
    nb = 8
    ob = (theta / (2 * jnp.pi) * nb) % nb
    o0 = jnp.floor(ob).astype(jnp.int32) % nb
    fo = ob - jnp.floor(ob)
    Wo = jax.nn.one_hot(o0, nb, dtype=dtype) * (1 - fo)[..., None] + jax.nn.one_hot(
        (o0 + 1) % nb, nb, dtype=dtype
    ) * fo[..., None]  # (K, n*n, 8)

    desc = jnp.einsum("kn,ns,kno->kso", wgt, Wsp, Wo)  # (K, 16, 8)
    desc = desc.reshape(-1, 128)

    # OpenCV normalization: L2 -> clip 0.2 -> L2 -> scale 512 -> round and
    # saturate to [0, 255] (cv2 stores saturate_cast<uchar> values even in
    # its float descriptors). Integers up to 256 are exact in bf16, so the
    # matcher's bf16 operands lose nothing on these descriptors.
    norm = jnp.linalg.norm(desc, axis=1, keepdims=True) + 1e-12
    desc = jnp.minimum(desc / norm, 0.2)
    norm = jnp.linalg.norm(desc, axis=1, keepdims=True) + 1e-12
    return jnp.clip(jnp.round(desc / norm * 512.0), 0.0, 255.0)


# ---------------------------------------------------------------- pipeline
@functools.partial(
    jax.jit,
    static_argnames=(
        "max_features",
        "n_layers",
        "contrast_threshold",
        "edge_threshold",
        "upsample",
        "n_octaves",
    ),
)
def _sift_detect(
    images: jax.Array,
    max_features: int,
    n_layers: int,
    contrast_threshold: float,
    edge_threshold: float,
    upsample: bool,
    n_octaves: int,
):
    """Phase 1: pyramid + extrema + global candidate selection.

    Returns (gaussians list, cand dict of (B, F) arrays: x, y in OCTAVE
    coords, layer, sigma_rel, response, octave id, valid) — everything the
    describe phase needs, WITHOUT the expensive per-candidate work."""
    gaussians, dogs = build_pyramid(
        images, n_octaves, n_layers, upsample=upsample
    )
    sigma0 = 1.6
    per_oct = []
    for o in range(n_octaves):
        ext = _find_octave_extrema(
            dogs[o], contrast_threshold, edge_threshold, n_layers,
            max_features,
        )
        layer_f = ext["layer"].astype(images.dtype) + ext["off_s"]
        per_oct.append(
            {
                "x": ext["x"],
                "y": ext["y"],
                "layer": ext["layer"],
                "sigma_rel": sigma0 * (2.0 ** (layer_f / n_layers)),
                "response": ext["response"],
                "valid": ext["valid"],
                "octave": jnp.full_like(ext["layer"], o),
            }
        )
    merged = {
        k: jnp.concatenate([p[k] for p in per_oct], axis=1)
        for k in per_oct[0]
    }
    # global top-F by response among valid: valid candidates (score > 0)
    # sort ahead of the -1-scored padding, so the selected prefix of any
    # length >= the true count holds every real candidate
    score = jnp.where(merged["valid"], merged["response"], -1.0)
    _, top = select_top_k(score, max_features)  # (B, F)
    cand = {
        k: jnp.take_along_axis(merged[k], top, axis=1) for k in merged
    }
    cand["n_valid"] = jnp.sum(merged["valid"], axis=1)
    return gaussians, cand


@functools.partial(jax.jit, static_argnames=("octave",))
def _sift_describe_octave(G, cand_k, octave: int):
    """Phase 2 (per octave): orientation + descriptor for the compact
    candidate slice, masked to this octave's members."""

    def per_image(Gi, xi, yi, li, sri):
        def samp(sx, sy):
            return _bilinear(Gi, sx, sy, li[:, None])

        ang, _ang2, _has2 = _keypoint_orientation(
            samp, xi, yi, sri, Gi.dtype
        )
        descs = _keypoint_descriptor(samp, xi, yi, sri, ang, Gi.dtype)
        return ang, descs

    mine = (cand_k["octave"] == octave) & cand_k["valid"]
    # evaluate at benign coords for foreign/invalid slots (results masked)
    xs = jnp.where(mine, cand_k["x"], 16.0)
    ys = jnp.where(mine, cand_k["y"], 16.0)
    ang, descs = jax.vmap(per_image)(
        G, xs, ys, cand_k["layer"], cand_k["sigma_rel"]
    )
    return ang, descs, mine


@jax.jit
def _sift_describe_flat(flat, xs, ys, lvl, sig, base, h_o, w_o):
    """Phase 2, ALL octaves in ONE dispatch (r5).

    The per-octave form ran n_octaves jitted calls, each describing the
    full k_sel candidate slice and masking foreign octaves — ~5x the
    gather work and 5 device round trips on insel (2.4 s of the 5.3 s
    warm wall). Here the whole Gaussian pyramid is FLATTENED per image
    (flat (B, T)) and each keypoint samples its own octave plane through
    per-keypoint (base, H, W) offsets — flat 1D gathers, the fast XLA
    gather mode. One call, one compile, work sized by k_sel once.

    xs/ys/lvl/sig: (B, K) octave-local candidate data; base/h_o/w_o:
    (B, K) int32 per-keypoint flat offset + octave plane dims."""

    def per_image(fi, x, y, li, sri, bi, hi, wi):
        Hk = hi[:, None]
        Wk = wi[:, None]
        lk = li[:, None]
        bk = bi[:, None]

        def samp(sx, sy):
            x0 = jnp.floor(sx)
            y0 = jnp.floor(sy)
            fx = sx - x0
            fy = sy - y0
            x0i = x0.astype(jnp.int32)
            y0i = y0.astype(jnp.int32)

            def at(yy, xx):
                inside = (yy >= 0) & (yy < Hk) & (xx >= 0) & (xx < Wk)
                yc = jnp.clip(yy, 0, Hk - 1)
                xc = jnp.clip(xx, 0, Wk - 1)
                idx = bk + (lk * Hk + yc) * Wk + xc
                return jnp.where(inside, fi[idx], 0.0)

            return (
                at(y0i, x0i) * (1 - fx) * (1 - fy)
                + at(y0i, x0i + 1) * fx * (1 - fy)
                + at(y0i + 1, x0i) * (1 - fx) * fy
                + at(y0i + 1, x0i + 1) * fx * fy
            )

        ang, ang2, has2 = _keypoint_orientation(samp, x, y, sri, fi.dtype)
        descs = _keypoint_descriptor(samp, x, y, sri, ang, fi.dtype)
        descs2 = _keypoint_descriptor(samp, x, y, sri, ang2, fi.dtype)
        return ang, descs, ang2, descs2, has2

    return jax.vmap(per_image)(flat, xs, ys, lvl, sig, base, h_o, w_o)


def sift_features(
    images: jax.Array,  # (B, H, W) float in [0, 1] (or uint8)
    max_features: int = 2048,
    n_layers: int = 3,
    contrast_threshold: float = 0.04,
    edge_threshold: float = 10.0,
    upsample: bool = True,
) -> dict:
    """Full batched SIFT. Returns dict with keys
    keypoints (B,F,2 — x,y in original pixels), scale, angle, response,
    valid (B,F), descriptors (B,F,128).

    Two-phase host orchestration (a pure-jit version evaluated orientation
    + descriptors for max_features candidates PER OCTAVE — ~40x the real
    detection count at the reference's contrast threshold, and the ~9k
    bilinear taps per candidate made the frontend gather-bound at ~21 s on
    insel): phase 1 (one jit) detects and globally ranks candidates; the
    host then reads the true count and sizes phase 2 to the next power of
    two, so orientation/descriptor work scales with DETECTED features.
    Compiled programs are per (image shape, bucket) and hit the persistent
    cache on reruns."""
    if images.dtype == jnp.uint8:
        images = images.astype(jnp.float32) / 255.0
    b, h, w = images.shape
    base_dim = min(h, w) * (2 if upsample else 1)
    n_octaves = max(1, int(math.floor(math.log2(base_dim / 16))))

    gaussians, cand = _sift_detect(
        images, max_features, n_layers, contrast_threshold, edge_threshold,
        upsample, n_octaves,
    )

    # size the describe phase to the actual detection count
    n_valid = int(np.max(np.asarray(cand["n_valid"])))
    k_sel = 128
    while k_sel < min(n_valid, max_features):
        k_sel *= 2
    k_sel = min(k_sel, max_features)

    cand_k = {k: v[:, :k_sel] for k, v in cand.items() if k != "n_valid"}
    F = max_features

    # r5: one flat-pyramid describe dispatch for all octaves (see
    # _sift_describe_flat). Per-image pyramid sizes/offsets are static.
    sizes = [int(np.prod(g.shape[1:])) for g in gaussians]
    off_tab = jnp.asarray(
        np.concatenate([[0], np.cumsum(sizes)])[:-1], jnp.int32
    )
    h_tab = jnp.asarray([g.shape[2] for g in gaussians], jnp.int32)
    w_tab = jnp.asarray([g.shape[3] for g in gaussians], jnp.int32)
    flat = jnp.concatenate([g.reshape(b, -1) for g in gaussians], axis=1)

    valid_k = cand_k["valid"]
    oct_k = jnp.clip(cand_k["octave"], 0, n_octaves - 1)
    nlev = gaussians[0].shape[1]
    xs = jnp.where(valid_k, cand_k["x"], 16.0)
    ys = jnp.where(valid_k, cand_k["y"], 16.0)
    lvl_k = jnp.clip(cand_k["layer"], 0, nlev - 1)
    ang_k, desc_k, ang2_k, desc2_k, has2_k = _sift_describe_flat(
        flat, xs, ys, lvl_k, cand_k["sigma_rel"],
        off_tab[oct_k], h_tab[oct_k], w_tab[oct_k],
    )

    # r5 (OpenCV parity): secondary orientation peaks >= 0.8 * max emit a
    # SECOND keypoint at the same location (cv::SIFT duplicates these;
    # they were most of the r3-r4 ~15% count gap vs cv2 and cost match
    # recall). Pool primaries + secondaries, then fill the F capacity by
    # response like the reference's retainBest.
    scale_k = (2.0 ** cand_k["octave"].astype(images.dtype)) / (
        2.0 if upsample else 1.0
    )
    kp_k = jnp.stack([cand_k["x"], cand_k["y"]], -1) * scale_k[..., None]
    valid2 = valid_k & has2_k

    def pool(a, b2):
        return jnp.concatenate([a, b2], axis=1)

    p_kp = pool(kp_k, kp_k)
    p_scale = pool(cand_k["sigma_rel"] * scale_k, cand_k["sigma_rel"] * scale_k)
    p_resp = pool(cand_k["response"], cand_k["response"])
    p_ang = pool(jnp.where(valid_k, ang_k, 0.0), jnp.where(valid2, ang2_k, 0.0))
    p_desc = pool(
        jnp.where(valid_k[..., None], desc_k, 0.0),
        jnp.where(valid2[..., None], desc2_k, 0.0),
    )
    p_valid = pool(valid_k, valid2)

    def place(x, fill=0.0):
        """Fit the pooled (B, 2*k_sel, ...) arrays into the F capacity."""
        if 2 * k_sel <= F:
            shape = (b, F) + x.shape[2:]
            return jnp.zeros(shape, x.dtype).at[:, : 2 * k_sel].set(x)
        return x  # handled by the top-F gather below

    if 2 * k_sel <= F:
        keypoints = place(p_kp)
        scale = place(p_scale)
        angle = place(p_ang)
        response = place(p_resp)
        descs = place(p_desc)
        valid = place(p_valid)
    else:
        # top-F by response among valid pooled slots (reference retainBest
        # counts orientation duplicates toward the feature limit too)
        score = jnp.where(p_valid, p_resp, -1.0)
        _, sel = jax.lax.top_k(score, F)  # (B, F)
        take = lambda x: jnp.take_along_axis(
            x, sel.reshape(sel.shape + (1,) * (x.ndim - 2)), axis=1
        )
        keypoints = take(p_kp)
        scale = take(p_scale)
        angle = take(p_ang)
        response = take(p_resp)
        descs = take(p_desc)
        valid = jnp.take_along_axis(p_valid, sel, axis=1)

    return {
        "keypoints": keypoints,
        "scale": scale,
        "angle": angle,
        "response": response,
        "valid": valid,
        "descriptors": descs,
    }
