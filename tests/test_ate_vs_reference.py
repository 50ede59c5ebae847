"""ATE vs a cv2-oracle reference trajectory on the insel dataset.

The north-star acceptance metric (BASELINE.json): this pipeline's camera
trajectory must match the reference pipeline's on the insel configs. The
reference binary does not build here, but utils/oracle.py re-enacts its
exact SfM call stack (SfM.cpp:143-381) with cv2 + an independent scipy LM
bundle adjustment — no code shared with this pipeline. Both run on the
bundled insel frames (360x202, downscaled from the original 720x405) with
the reference CLI defaults; trajectories are
compared after sim(3) alignment (utils/metrics.py::trajectory_compare),
including optical-axis angles, which get no say in the alignment and are
therefore a genuinely independent check with only 3 cameras.
"""

import os

import numpy as np
import pytest

INSEL = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "sample_data", "insel",
)


def test_ate_vs_cv2_oracle(tmp_path):
    import cv2

    from sfm_mvs_pipeline.cli.app import main
    from sfm_mvs_pipeline.ops.pose import aa_to_rotmat
    from sfm_mvs_pipeline.utils.checkpoint import load_scene
    from sfm_mvs_pipeline.utils.metrics import trajectory_compare
    from sfm_mvs_pipeline.utils.oracle import oracle_reconstruct

    paths = sorted(
        os.path.join(INSEL, n) for n in os.listdir(INSEL)
        if n.lower().endswith((".jpg", ".png"))
    )
    oracle = oracle_reconstruct(paths)
    assert len(oracle["recovered"]) == 3, "oracle must recover all 3 views"

    out = tmp_path / "out"
    rc = main(
        [
            "-Prun=photogrammetrie",
            f"-Pimage={INSEL}",
            f"-Pout={out}",
            "-Pfeature-limit=1000",
            "-Ploglevel=3",
        ]
    )
    assert rc == 0
    scene = load_scene(str(out / "scene.npz"))
    assert int(scene.recovered.sum()) == 3, "the pipeline must recover all 3 views"

    est_centers, est_R = [], []
    for s in range(3):
        R = np.asarray(aa_to_rotmat(scene.poses[s][:3]))
        est_centers.append(-R.T @ scene.poses[s][3:])
        est_R.append(R)
    ref_centers, ref_R = [], []
    for s in oracle["recovered"]:
        R = cv2.Rodrigues(oracle["rvecs"][s])[0]
        ref_centers.append((-R.T @ oracle["tvecs"][s]).ravel())
        ref_R.append(R)

    cmpres = trajectory_compare(
        np.asarray(est_centers), np.asarray(est_R),
        np.asarray(ref_centers), np.asarray(ref_R),
    )
    # scene scale: the oracle trajectory's extent
    extent = max(
        np.linalg.norm(a - b)
        for a in ref_centers for b in ref_centers
    )
    rel_ate = cmpres["ate_rmse"] / extent
    print(
        f"ATE {cmpres['ate_rmse']:.4f} ({rel_ate:.3%} of trajectory extent), "
        f"relative rotation mean {cmpres['mean_rel_rot_deg']:.2f} deg "
        f"max {cmpres['max_rel_rot_deg']:.2f} deg, scale {cmpres['scale']:.3f}"
    )
    # acceptance bounds (BASELINE.json: "ATE within reference bound")
    assert rel_ate < 0.05, f"relative ATE {rel_ate:.3%} exceeds 5% of extent"
    assert cmpres["max_rel_rot_deg"] < 3.0, (
        f"relative rotation deviates {cmpres['max_rel_rot_deg']:.2f} deg "
        f"from the oracle"
    )
