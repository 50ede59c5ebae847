"""Host-side image IO: enumerate, decode, resize, colorize support.

Replaces the reference's CameraShot::loadMImage / Scene::colorizePointcloud
image handling (ref: src/photogrammetrie/common/CameraShot.cpp:37-48,
Scene.cpp:569-617). Decoding is host-side; the device sees only dense
arrays.

PNG, PGM and PPM are read and PNG is written with numpy and zlib alone, so
the main path needs no OpenCV. JPEG, TIFF, WebP and BMP are decoded through
OpenCV when the `io` extra is installed; without it they raise an error
that names the extra. Resizing is one numpy area resample (the semantics of
cv2.INTER_AREA) and gray conversion uses the BT.601 weights in OpenCV's
fixed-point form, so a gray image is bit-identical to cv2's.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_IMG_EXTS = {".jpg", ".jpeg", ".png", ".pgm", ".ppm", ".pnm", ".bmp",
             ".tif", ".tiff", ".webp"}
_NUMPY_EXTS = {".png", ".pgm", ".ppm", ".pnm"}
_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def list_images(directory: str) -> list[str]:
    """Sorted image paths in a directory (ref sorts lexicographically;
    PhotogrammetrieCli.cpp:252-280)."""
    out = [
        os.path.join(directory, f)
        for f in sorted(os.listdir(directory))
        if os.path.splitext(f)[1].lower() in _IMG_EXTS
    ]
    if not out:
        raise FileNotFoundError(f"no images found in {directory}")
    return out


# ------------------------------------------------------------------ decode
def _unfilter_png(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters of a (h, 1 + stride) byte array.

    Rows filtered None/Sub/Up decode row-vectorised. Average and Paeth
    depend on the left and upper neighbours, so an image that uses them is
    decoded along anti-diagonals of pixels: H + W vectorised steps."""
    ftype = raw[:, 0]
    data = raw[:, 1:].astype(np.int32)
    if ftype.max() > 4:
        raise ValueError(f"bad PNG filter type {int(ftype.max())}")
    n = stride // bpp
    if not np.isin(ftype, (3, 4)).any():
        out = np.empty((h, stride), np.uint8)
        prior = np.zeros(stride, np.int32)
        for r in range(h):
            row = data[r]
            if ftype[r] == 1:
                row = np.cumsum(row.reshape(n, bpp), axis=0).reshape(-1)
            elif ftype[r] == 2:
                row = row + prior
            prior = row & 255
            out[r] = prior
        return out
    # anti-diagonal decode; x is zero-padded by one row on top and one
    # pixel on the left so the neighbours a, b, c always exist
    x = np.zeros((h + 1, n + 1, bpp), np.int32)
    d = data.reshape(h, n, bpp)
    for k in range(h + n - 1):
        r = np.arange(max(0, k - n + 1), min(h, k + 1))
        j = k - r
        a = x[r + 1, j]
        b = x[r, j + 1]
        c = x[r, j]
        f = ftype[r][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select(
            [f == 1, f == 2, f == 3, f == 4],
            [a, b, (a + b) >> 1, paeth],
            0,
        )
        x[r + 1, j + 1] = (d[r, j] + pred) & 255
    return x[1:, 1:].reshape(h, stride).astype(np.uint8)


def _read_png(buf: bytes, path: str) -> np.ndarray:
    if buf[:8] != _PNG_SIG:
        raise IOError(f"not a PNG file: {path}")
    pos, idat, palette = 8, [], None
    hdr = None
    while pos < len(buf):
        (length,) = struct.unpack(">I", buf[pos:pos + 4])
        kind = buf[pos + 4:pos + 8]
        body = buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise IOError(f"PNG without IHDR: {path}")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    if interlace:
        raise IOError(f"interlaced PNG is not supported: {path}")
    chans = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    bits = depth * chans
    stride = (w * bits + 7) // 8
    bpp = max(1, bits // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter_png(raw.reshape(h, stride + 1), h, stride, bpp)
    if depth == 16:
        img = px.view(">u2").reshape(h, w, chans)
        img = (img >> 8).astype(np.uint8)  # cv2 keeps the high byte too
    elif depth == 8:
        img = px.reshape(h, w, chans)
    else:  # 1, 2 or 4 bit gray or palette indices
        bitsarr = np.unpackbits(px, axis=1).reshape(h, -1, depth)[:, :w]
        weights = 1 << np.arange(depth - 1, -1, -1)
        img = (bitsarr * weights).sum(-1).astype(np.uint8)[..., None]
        if ctype == 0:
            img = (img.astype(np.int32) * 255 // ((1 << depth) - 1)).astype(
                np.uint8
            )
    if ctype == 3:
        if palette is None:
            raise IOError(f"palette PNG without PLTE: {path}")
        return palette[img[..., 0]]
    if chans in (2, 4):
        img = img[..., :-1]  # drop alpha
    return img[..., 0] if img.shape[-1] == 1 else img


def _read_pnm(buf: bytes, path: str) -> np.ndarray:
    tokens, pos = [], 0
    while len(tokens) < 4:
        while buf[pos:pos + 1].isspace():
            pos += 1
        if buf[pos:pos + 1] == b"#":
            pos = buf.index(b"\n", pos)
            continue
        end = pos
        while not buf[end:end + 1].isspace():
            end += 1
        tokens.append(buf[pos:end])
        pos = end
    magic, w, h, maxval = tokens[0], *(int(t) for t in tokens[1:])
    if magic not in (b"P5", b"P6"):
        raise IOError(f"only binary PGM/PPM (P5/P6) are supported: {path}")
    chans = 1 if magic == b"P5" else 3
    dt = np.dtype(">u2") if maxval > 255 else np.dtype(np.uint8)
    data = np.frombuffer(buf, dt, count=w * h * chans, offset=pos + 1)
    img = data.reshape(h, w, chans).astype(np.float64)
    if maxval != 255:
        img = np.rint(img * (255.0 / maxval))
    img = img.astype(np.uint8)
    return img[..., 0] if chans == 1 else img


def read_image(path: str) -> np.ndarray:
    """Decode an image file to uint8: (H, W) gray or (H, W, 3) RGB.

    PNG (8/16-bit, gray, RGB, palette, with or without alpha, not
    interlaced), PGM and PPM decode with numpy and zlib. Other formats
    need OpenCV, installed with the `io` extra."""
    ext = os.path.splitext(path)[1].lower()
    if ext in _NUMPY_EXTS:
        try:
            with open(path, "rb") as f:
                buf = f.read()
        except OSError as e:
            raise IOError(f"cannot read image: {path}") from e
        if buf[:8] == _PNG_SIG:
            return _read_png(buf, path)
        return _read_pnm(buf, path)
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"decoding {ext} images needs OpenCV: install the `io` extra "
            f"(pip install 'sfm-mvs-pipeline[io]') or convert {path} to PNG"
        ) from e
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"cannot read image: {path}")
    return img[..., ::-1].copy()  # BGR -> RGB


# ------------------------------------------------------------------ encode
def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 (H, W) gray or (H, W, 3) RGB image as PNG.

    Each row takes the None, Sub or Up filter, whichever leaves the
    smallest sum of absolute residuals (the usual encoder heuristic)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    chans = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}[chans]
    rows = img.reshape(h, w * chans).astype(np.int16)
    sub = rows.copy()
    sub[:, chans:] -= rows[:, :-chans]
    up = rows.copy()
    up[1:] -= rows[:-1]
    cands = np.stack([rows, sub, up]).astype(np.uint8)  # mod 256
    score = np.abs(cands.view(np.int8).astype(np.int32)).sum(-1)
    best = np.argmin(score, axis=0)
    filt = cands[best, np.arange(h)]
    raw = np.concatenate([best.astype(np.uint8)[:, None], filt], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)

    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes())))
        f.write(chunk(b"IEND", b""))


# --------------------------------------------------------- pixel transforms
def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """uint8 RGB -> uint8 gray with the BT.601 weights (0.299, 0.587, 0.114)
    in OpenCV's 15-bit fixed point, bit-identical to cv2.COLOR_RGB2GRAY."""
    c = rgb.astype(np.int32)
    y = c[..., 0] * 9798 + c[..., 1] * 19235 + c[..., 2] * 3735 + (1 << 14)
    return (y >> 15).astype(np.uint8)


def _area_axis(a: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    """Area-average a along one axis to n_out samples: each output sample is
    the mean of the input over its footprint [d*s, (d+1)*s), s = n_in/n_out,
    read off the running integral of the piecewise-constant input."""
    n_in = a.shape[axis]
    if n_in == n_out:
        return a
    a = np.moveaxis(a, axis, 0)
    cs = np.concatenate([np.zeros_like(a[:1]), np.cumsum(a, axis=0)])
    edges = np.arange(n_out + 1) * (n_in / n_out)
    i = np.minimum(np.floor(edges).astype(np.int64), n_in)
    frac = (edges - i).reshape((-1,) + (1,) * (a.ndim - 1))
    integral = cs[i] + frac * a[np.minimum(i, n_in - 1)]
    out = (integral[1:] - integral[:-1]) * (n_out / n_in)
    return np.moveaxis(out, 0, axis)


def resize_area(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Resize an (H, W) or (H, W, C) image to size = (w, h) by area
    averaging (cv2.INTER_AREA semantics when shrinking). uint8 input is
    rounded back to uint8; float input keeps its dtype."""
    w, h = size
    out = img.astype(np.float64)
    out = _area_axis(_area_axis(out, h, 0), w, 1)
    if img.dtype == np.uint8:
        return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)
    return out.astype(img.dtype)


# ------------------------------------------------------------------ drawing
# a 1-px ring of radius 2 (what cv2.circle(img, c, 2, color, 1) draws)
_RING = [(-2, -1), (-2, 0), (-2, 1), (2, -1), (2, 0), (2, 1), (-1, -2),
         (0, -2), (1, -2), (-1, 2), (0, 2), (1, 2)]


def draw_circles(img: np.ndarray, xy: np.ndarray, color) -> None:
    """Draw a radius-2 ring at every (x, y) of xy into img, in place."""
    h, w = img.shape[:2]
    c = np.round(np.asarray(xy, np.float64)).astype(np.int64)
    for dx, dy in _RING:
        x, y = c[:, 0] + dx, c[:, 1] + dy
        ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        img[y[ok], x[ok]] = color


def draw_lines(img: np.ndarray, p0: np.ndarray, p1: np.ndarray, color) -> None:
    """Draw 1-px segments p0[i] -> p1[i] ((N, 2) x, y) into img, in place."""
    h, w = img.shape[:2]
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    for a, b in zip(p0, p1):
        n = int(np.ceil(np.abs(b - a).max())) + 1
        t = np.linspace(0.0, 1.0, n)[:, None]
        pts = np.round(a + t * (b - a)).astype(np.int64)
        ok = (pts[:, 0] >= 0) & (pts[:, 0] < w) & (pts[:, 1] >= 0) & (pts[:, 1] < h)
        img[pts[ok, 1], pts[ok, 0]] = color


# ------------------------------------------------------------------ loaders
def load_gray_batch(
    paths: list[str], size: tuple[int, int] | None = None
) -> tuple[np.ndarray, tuple[int, int]]:
    """Load images as a (B, H, W) float32 [0,1] batch, resizing everything to
    the first image's resolution (the reference ties all shots to one shared
    camera resolution; CameraShot.cpp:37-48). Returns (batch, (width, height))."""
    imgs = []
    wh = size
    for p in paths:
        img = read_image(p)
        if img.ndim == 3:
            img = rgb_to_gray(img)
        if wh is None:
            wh = (img.shape[1], img.shape[0])
        if (img.shape[1], img.shape[0]) != wh:
            img = resize_area(img, wh)
        imgs.append(img.astype(np.float32) / 255.0)
    return np.stack(imgs), wh


def load_rgb(path: str, size: tuple[int, int] | None = None) -> np.ndarray:
    """Load one image as (H, W, 3) uint8 RGB."""
    img = read_image(path)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if size is not None and (img.shape[1], img.shape[0]) != size:
        img = resize_area(img, size)
    return img


def scale_letterbox(
    img: np.ndarray, dst_size: tuple[int, int], fill=0
) -> np.ndarray:
    """Aspect-preserving resize into (w, h) with centered letterbox padding
    (ref: OpenCvUtils::scale, src/photogrammetrie/util/OpenCvUtils.cpp:93-140)."""
    dw, dh = dst_size
    h, w = img.shape[:2]
    if (w, h) == (dw, dh):
        return img.copy()
    factor = min(dw / w, dh / h)
    sw = max(int(round(w * factor)), 1)
    sh = max(int(round(h * factor)), 1)
    scaled = resize_area(img, (sw, sh))
    shape = (dh, dw) + img.shape[2:]
    out = np.full(shape, fill, dtype=img.dtype)
    x0 = abs(dw - sw) // 2
    y0 = abs(dh - sh) // 2
    out[y0 : y0 + sh, x0 : x0 + sw] = scaled
    return out


def scale_points(points: np.ndarray, scale: float) -> np.ndarray:
    """Uniformly scale 2D points (ref: OpenCvUtils::scalePoints,
    OpenCvUtils.cpp:142-146)."""
    return np.asarray(points) * scale


def scaled_intrinsics(K: np.ndarray, scale: float) -> np.ndarray:
    """Scale the first two rows of a 3x3 K for a resized image
    (ref: OpenCvUtils::scaledK, OpenCvUtils.h:194-213)."""
    K = np.asarray(K, np.float64)
    if K.shape != (3, 3):
        raise ValueError("expected a 3x3 camera matrix")
    out = K.copy()
    out[:2] *= scale
    return out


def stereo_matcher_roi(
    src_size: tuple[int, int],
    min_disparity: int,
    num_disparities: int,
    block_size: int,
) -> tuple[int, int, int, int]:
    """Valid-disparity ROI (x, y, w, h) of a block stereo matcher
    (ref: OpenCvUtils::computeStereoMatcherROI, OpenCvUtils.cpp:148-163)."""
    w, h = src_size
    half = block_size // 2
    max_disparity = min_disparity + num_disparities - 1
    x_min = max_disparity + half
    x_max = w + min_disparity - half
    y_min = half
    y_max = h - half
    return (x_min, y_min, x_max - x_min, y_max - y_min)


def colorize_points(scene) -> None:
    """Fill scene.colors by sampling each point's first-origin pixel pair and
    averaging, one image load per shot (ref: Scene::colorizePointcloud,
    Scene.cpp:569-617 — samples ONE origin's left/right pixels and averages,
    short-circuiting after the first origin)."""
    n = scene.n_points
    acc = np.zeros((n, 3), np.float64)
    cnt = np.zeros(n, np.float64)
    # first two observations per point = the first origin's pixel pair
    order = np.argsort(scene.obs_point, kind="stable")
    op = scene.obs_point[order]
    start = np.searchsorted(op, np.arange(n), side="left")
    end = np.searchsorted(op, np.arange(n), side="right")
    take = []  # (obs_index) list for first up to 2 obs of each point
    for p in range(n):
        for k in range(start[p], min(end[p], start[p] + 2)):
            take.append(order[k])
    take = np.asarray(take, np.int64)
    if len(take) == 0:
        return
    shots = scene.obs_shot[take]
    uvs = scene.obs_uv[take]
    pts = scene.obs_point[take]
    w, h = scene.image_size
    for s in np.unique(shots):
        img = load_rgb(scene.image_paths[s], scene.image_size)
        sel = shots == s
        x = np.clip(np.round(uvs[sel, 0]).astype(int), 0, w - 1)
        y = np.clip(np.round(uvs[sel, 1]).astype(int), 0, h - 1)
        np.add.at(acc, pts[sel], img[y, x].astype(np.float64))
        np.add.at(cnt, pts[sel], 1.0)
    ok = cnt > 0
    rgb = np.zeros((n, 3), np.uint8)
    rgb[ok] = np.clip(acc[ok] / cnt[ok, None], 0, 255).astype(np.uint8)
    scene.colors = np.concatenate(
        [rgb, np.full((n, 1), 255, np.uint8)], axis=1
    )
