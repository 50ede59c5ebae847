"""Native C++ tier: kd-tree kNN vs brute force, PLY writer round-trips,
and the pure-Python fallbacks staying equivalent."""

import os
import subprocess
import sys

import numpy as np
import pytest

from sfm_mvs_pipeline import native
from sfm_mvs_pipeline.utils.ply import read_ply, write_ply_mesh, write_ply_points
from sfm_mvs_pipeline.utils.stats import knn_distances


def _brute_kth(pts, k):
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return np.sqrt(np.sort(d2, axis=1)[:, k - 1])


@pytest.mark.skipif(not native.available(), reason="no native toolchain")
def test_native_knn_matches_brute_force(rng):
    pts = rng.normal(size=(700, 3)).astype(np.float32)
    for k in (1, 4):
        d = native.knn_kth_distance(pts, k)
        np.testing.assert_allclose(d, _brute_kth(pts, k), rtol=1e-5, atol=1e-6)
    dk = native.knn_all_distances(pts, 4)
    np.testing.assert_allclose(dk[:, 3], _brute_kth(pts, 4), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dk[:, 0], _brute_kth(pts, 1), rtol=1e-5, atol=1e-6)


@pytest.mark.skipif(not native.available(), reason="no native toolchain")
def test_native_knn_duplicate_points(rng):
    # self-exclusion is by index, so exact duplicates report distance 0
    pts = np.repeat(rng.normal(size=(5, 3)).astype(np.float32), 2, axis=0)
    d = native.knn_kth_distance(pts, 1)
    np.testing.assert_allclose(d, 0.0, atol=1e-7)


@pytest.mark.skipif(not native.available(), reason="no native toolchain")
def test_native_ply_roundtrip(tmp_path, rng):
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, (64, 3)).astype(np.uint8)
    nrm = rng.normal(size=(64, 3)).astype(np.float32)
    faces = rng.integers(0, 64, (30, 3)).astype(np.int32)
    p = str(tmp_path / "m.ply")
    assert native.write_ply_native(p, pts, rgb, nrm, faces)
    r = read_ply(p)
    np.testing.assert_allclose(r["points"], pts, atol=0)
    np.testing.assert_array_equal(r["colors"][:, :3], rgb)
    np.testing.assert_allclose(r["normals"], nrm, atol=0)
    np.testing.assert_array_equal(r["faces"], faces)


def test_python_fallback_matches_native(tmp_path, rng):
    """With SFM_NO_NATIVE set, knn_distances and the PLY writers take the
    numpy path and must produce identical results/files as the native path."""
    pts = rng.normal(size=(128, 3))
    code = (
        "import numpy as np\n"
        "from sfm_mvs_pipeline.utils.stats import knn_distances\n"
        "from sfm_mvs_pipeline.utils.ply import write_ply_points\n"
        f"pts = np.load({str(tmp_path / 'pts.npy')!r})\n"
        f"np.save({str(tmp_path / 'd.npy')!r}, knn_distances(pts))\n"
        f"write_ply_points({str(tmp_path / 'py.ply')!r}, pts)\n"
    )
    np.save(tmp_path / "pts.npy", pts)
    env = dict(os.environ, SFM_NO_NATIVE="1", JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", code], check=True, env=env)
    d_py = np.load(tmp_path / "d.npy")
    np.testing.assert_allclose(d_py, knn_distances(pts), rtol=1e-5, atol=1e-6)
    write_ply_points(str(tmp_path / "any.ply"), pts)
    a = read_ply(str(tmp_path / "py.ply"))
    b = read_ply(str(tmp_path / "any.ply"))
    np.testing.assert_allclose(a["points"], b["points"], atol=0)


def test_write_ply_points_uses_some_path(tmp_path, rng):
    # whichever tier is active, the public writer must emit a readable file
    pts = rng.normal(size=(10, 3))
    rgba = rng.integers(0, 255, (10, 4)).astype(np.uint8)
    write_ply_points(str(tmp_path / "a.ply"), pts, rgba)  # alpha -> numpy path
    r = read_ply(str(tmp_path / "a.ply"))
    assert r["points"].shape == (10, 3) and r["colors"].shape[1] >= 3
    faces = rng.integers(0, 10, (4, 3))
    write_ply_mesh(str(tmp_path / "b.ply"), pts, faces)
    assert read_ply(str(tmp_path / "b.ply"))["faces"].shape == (4, 3)
