"""Host image IO without OpenCV, checked against OpenCV as the oracle:
PNG/PGM/PPM decode and PNG encode, the area resample, gray conversion and
the artifact drawing helpers."""

import struct
import sys
import zlib

import numpy as np
import pytest

from sfm_mvs_pipeline.utils import images as I


@pytest.mark.parametrize("shape", [(37, 53), (40, 61, 3)])
def test_png_round_trip(rng, tmp_path, shape):
    """write_png -> read_image is lossless, and cv2 reads the same pixels."""
    import cv2

    img = (rng.random(shape) * 255).astype(np.uint8)
    img[::3] = img[::3] // 2  # smooth rows so Sub/Up filters get picked
    p = str(tmp_path / "x.png")
    I.write_png(p, img)
    np.testing.assert_array_equal(I.read_image(p), img)
    cv = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(cv[..., ::-1] if cv.ndim == 3 else cv, img)


def _png_with_filter(img: np.ndarray, ftype: int) -> bytes:
    """Encode an RGB uint8 image with one PNG filter on every row (a plain
    Python encoder, independent of the reader under test)."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int64)
    rows = []
    for r in range(h):
        out = [ftype]
        for i in range(w * c):
            a = x[r, i - c] if i >= c else 0
            b = x[r - 1, i] if r else 0
            cc = x[r - 1, i - c] if (r and i >= c) else 0
            if ftype == 3:
                pred = (a + b) // 2
            else:
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
            out.append((x[r, i] - pred) % 256)
        rows.append(bytes(out))

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [3, 4])
def test_png_average_and_paeth_filters(rng, tmp_path, ftype):
    """Rows filtered Average (3) or Paeth (4) decode exactly."""
    img = (rng.random((9, 11, 3)) * 255).astype(np.uint8)
    p = tmp_path / "f.png"
    p.write_bytes(_png_with_filter(img, ftype))
    np.testing.assert_array_equal(I.read_image(str(p)), img)


def test_pnm_and_sixteen_bit(rng, tmp_path):
    import cv2

    rgb = (rng.random((20, 30, 3)) * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "x.ppm"), rgb[..., ::-1])
    cv2.imwrite(str(tmp_path / "x.pgm"), rgb[..., 0])
    np.testing.assert_array_equal(I.read_image(str(tmp_path / "x.ppm")), rgb)
    np.testing.assert_array_equal(I.read_image(str(tmp_path / "x.pgm")), rgb[..., 0])
    deep = (rng.random((20, 30)) * 65535).astype(np.uint16)
    cv2.imwrite(str(tmp_path / "d.png"), deep)
    np.testing.assert_array_equal(
        I.read_image(str(tmp_path / "d.png")), (deep >> 8).astype(np.uint8)
    )


def test_gray_matches_cv2():
    """BT.601 in 15-bit fixed point equals cv2.COLOR_RGB2GRAY bit for bit
    over every (R, G) pair at a spread of B values."""
    import cv2

    rg = np.stack(np.meshgrid(np.arange(256), np.arange(256), indexing="ij"),
                  -1).reshape(-1, 2)
    for b in (0, 37, 128, 255):
        rgb = np.concatenate([rg, np.full((len(rg), 1), b)], 1)
        rgb = rgb.astype(np.uint8)[None]
        np.testing.assert_array_equal(
            I.rgb_to_gray(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
        )


@pytest.mark.parametrize("size", [(80, 60), (64, 48), (53, 40), (100, 75)])
def test_resize_area_matches_cv2(rng, size):
    """The numpy area resample against cv2.INTER_AREA when shrinking a
    160x120 RGB image by 2, 2.5, ~3 and 1.6: at most one gray level apart
    (OpenCV accumulates its weights in float32)."""
    import cv2

    img = (rng.random((120, 160, 3)) * 255).astype(np.uint8)
    got = I.resize_area(img, size)
    want = cv2.resize(img, size, interpolation=cv2.INTER_AREA)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= 1


def test_jpeg_without_opencv_names_the_extra(tmp_path, monkeypatch):
    p = tmp_path / "x.jpg"
    p.write_bytes(b"\xff\xd8\xff")
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="`io` extra"):
        I.read_image(str(p))


def test_drawing_helpers():
    img = np.zeros((20, 30, 3), np.uint8)
    I.draw_circles(img, np.array([[10.0, 10.0], [0.0, 0.0]]), (0, 255, 0))
    assert (img[10, 12] == (0, 255, 0)).all() and (img[10, 10] == 0).all()
    assert (img[0, 2] == (0, 255, 0)).all()  # clipped at the border
    I.draw_lines(img, np.array([[0.0, 19.0]]), np.array([[29.0, 19.0]]),
                 (255, 0, 0))
    assert (img[19, :, 0] == 255).all()
