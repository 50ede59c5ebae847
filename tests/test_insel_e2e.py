"""End-to-end smoke test on the bundled insel dataset (downscaled).

The CPU twin of the reference's `build.sh fast-test` (ref: build.sh:233-239): full CLI drive — images -> SIFT ->
matching -> incremental SfM -> BA -> PLY/stat outputs. Uses a reduced
resolution + feature cap so the test stays in CI budget.
"""

import os

import numpy as np
import pytest

# the repo bundles a downscaled copy of the dataset (sample_data/README.md)
# so the smoke tests run standalone; the full-res original is only needed
# by the ATE test
INSEL = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "sample_data", "insel",
)


def test_insel_cli_end_to_end(tmp_path):
    import cv2

    from sfm_mvs_pipeline.cli.app import main

    # downscale the three frames into a temp dataset
    data = tmp_path / "insel_small"
    data.mkdir()
    for name in sorted(os.listdir(INSEL)):
        img = cv2.imread(os.path.join(INSEL, name))
        img = cv2.resize(img, (240, 135), interpolation=cv2.INTER_AREA)
        cv2.imwrite(str(data / name), img)

    out = tmp_path / "out"
    rc = main(
        [
            "-Prun=photogrammetrie",
            f"-Pimage={data}",
            f"-Pout={out}",
            "-Pfeature-limit=512",
            "--colored",
            "--stats",
        ]
    )
    assert rc == 0

    # sparse cloud + cameras + stats all written
    assert (out / "pointcloud_sparse.ply").exists()
    assert (out / "cameras_recovered.ply").exists()
    assert (out / "reprojectionerror.stat.csv").exists()
    assert (out / "scene.npz").exists()

    # reconstruction quality: all 3 views recovered with sub-pixel error
    from sfm_mvs_pipeline.utils.checkpoint import load_scene
    from sfm_mvs_pipeline.utils.stats import reprojection_errors

    scene = load_scene(str(out / "scene.npz"))
    assert scene.recovered.sum() == 3
    assert scene.point_valid.sum() > 50
    errs = reprojection_errors(scene)
    assert np.median(errs) < 1.0, f"median reprojection {np.median(errs)}"

    # colorized points are not all black
    live = scene.point_valid
    # colors live in the checkpoint; at least some color variation expected
    assert scene.colors[live][:, :3].max() > 30


def test_insel_cli_dense_mesh_end_to_end(tmp_path):
    """--dense --mesh --colored through the CLI on the bundled dataset
    (mirrors the reference fast-test flags, build.sh:233-239): the dense
    cloud and textured mesh must be written and non-trivial. Runs at
    240x135 with the default rectified engine so it stays in CI budget."""
    import cv2

    from sfm_mvs_pipeline.cli.app import main
    from sfm_mvs_pipeline.utils.ply import read_ply

    data = tmp_path / "insel_small"
    data.mkdir()
    for name in sorted(os.listdir(INSEL)):
        img = cv2.imread(os.path.join(INSEL, name))
        img = cv2.resize(img, (240, 135), interpolation=cv2.INTER_AREA)
        cv2.imwrite(str(data / name), img)

    out = tmp_path / "out"
    rc = main(
        [
            "-Prun=photogrammetrie",
            f"-Pimage={data}",
            f"-Pout={out}",
            "-Pfeature-limit=512",
            "--colored",
            "--dense",
            "--mesh",
        ]
    )
    assert rc == 0
    dense = read_ply(str(out / "pointcloud_dense.ply"))
    assert len(dense["points"]) > 1000, "dense cloud too small"
    assert dense["colors"] is not None and dense["colors"][:, :3].max() > 30
    mesh = read_ply(str(out / "mesh_dense.ply"))
    assert len(mesh["points"]) > 200
    assert len(mesh["faces"]) > 200


def test_insel_sequence_mode_recovers_all_views(tmp_path):
    """Sequence pairing (window 2) must register the out-of-baseline view.

    Regression: a stale device copy of the intrinsics (not refreshed after
    BA changed f/k1/k2) made PnP reject that view with a near-zero inlier
    ratio; the cv2 oracle recovers 3/3 on the same config."""
    import cv2

    from sfm_mvs_pipeline.cli.app import main
    from sfm_mvs_pipeline.utils.checkpoint import load_scene

    data = tmp_path / "insel_small"
    data.mkdir()
    for name in sorted(os.listdir(INSEL)):
        img = cv2.imread(os.path.join(INSEL, name))
        img = cv2.resize(img, (240, 135), interpolation=cv2.INTER_AREA)
        cv2.imwrite(str(data / name), img)

    out = tmp_path / "out"
    rc = main(
        [
            "-Prun=photogrammetrie",
            f"-Pimage={data}",
            f"-Pout={out}",
            "-Pfeature-limit=512",
            "-Pfeature-sequence=2",
            "-Ploglevel=4",
        ]
    )
    assert rc == 0
    scene = load_scene(str(out / "scene.npz"))
    assert int(scene.recovered.sum()) == 3


def test_resume_from_checkpoint_inside_out_dir(tmp_path):
    """-Presume= pointing at the PREVIOUS run's own scene.npz (inside
    -Pout) must survive the reference-semantics workdir wipe
    (PhotogrammetrieCli.cpp:399-402): the checkpoint is stashed before
    the wipe. Regression: the wipe deleted the checkpoint before it was
    read (FileNotFoundError)."""
    import cv2

    from sfm_mvs_pipeline.cli.app import main
    from sfm_mvs_pipeline.utils.checkpoint import load_scene

    data = tmp_path / "insel_small"
    data.mkdir()
    for name in sorted(os.listdir(INSEL)):
        img = cv2.imread(os.path.join(INSEL, name))
        img = cv2.resize(img, (240, 135), interpolation=cv2.INTER_AREA)
        cv2.imwrite(str(data / name), img)

    out = tmp_path / "out"
    base = [
        "-Prun=photogrammetrie",
        f"-Pimage={data}",
        f"-Pout={out}",
        "-Pfeature-limit=512",
        "-Ploglevel=4",
    ]
    assert main(base) == 0
    scene1 = load_scene(str(out / "scene.npz"))

    # resume from the checkpoint INSIDE the out dir, with colorization so
    # the resumed path does real work and rewrites the outputs
    rc = main(base + [f"-Presume={out / 'scene.npz'}", "--colored"])
    assert rc == 0
    assert (out / "pointcloud_sparse.ply").exists()
    scene2 = load_scene(str(out / "scene.npz"))
    assert int(scene2.recovered.sum()) == int(scene1.recovered.sum())
    np.testing.assert_allclose(scene2.poses, scene1.poses, atol=1e-6)
