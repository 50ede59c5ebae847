"""End-to-end trajectory accuracy vs ABSOLUTE ground truth.

Renders a parallax-rich two-plane scene from 8 known camera poses (pure
numpy ray-casting — no pipeline code involved), drives the full CLI
(SIFT -> matching -> incremental SfM -> BA), and compares the recovered
trajectory against the generating poses with sim(3)-aligned ATE and
gauge-free relative rotations. Unlike the insel ATE test (which compares
against a cv2 oracle) this one needs no oracle at all: the ground truth is
exact by construction.
"""

import os

import numpy as np


def _render_views(tmp, n_views=8, h=240, w=320, f=280.0):
    from sfm_mvs_pipeline.utils.synth import render_views

    data = tmp / "views"
    _paths, gt_R, gt_C = render_views(data, n_views, h, w, f)
    return data, gt_R, gt_C


def test_synthetic_trajectory_vs_ground_truth(tmp_path):
    from sfm_mvs_pipeline.cli.app import main
    from sfm_mvs_pipeline.ops.pose import aa_to_rotmat
    from sfm_mvs_pipeline.utils.checkpoint import load_scene
    from sfm_mvs_pipeline.utils.metrics import trajectory_compare

    data, gt_R, gt_C = _render_views(tmp_path)
    out = tmp_path / "out"
    rc = main(
        [
            "-Prun=photogrammetrie",
            f"-Pimage={data}",
            f"-Pout={out}",
            "-Pfeature-limit=800",
            "-Pfeature-sequence=3",
            "-Ploglevel=4",
        ]
    )
    assert rc == 0
    scene = load_scene(str(out / "scene.npz"))
    rec = np.nonzero(scene.recovered)[0]
    assert len(rec) >= 7, f"only {len(rec)}/8 views recovered"

    est_C, est_R = [], []
    for s in rec:
        R = np.asarray(aa_to_rotmat(scene.poses[s][:3]))
        est_C.append(-R.T @ scene.poses[s][3:])
        est_R.append(R)
    cmpres = trajectory_compare(
        np.asarray(est_C), np.asarray(est_R), gt_C[rec], gt_R[rec]
    )
    extent = np.linalg.norm(gt_C[rec][-1] - gt_C[rec][0])
    rel_ate = cmpres["ate_rmse"] / extent
    print(
        f"GT ATE {cmpres['ate_rmse']:.4f} ({rel_ate:.3%} of extent), "
        f"rel rot mean {cmpres['mean_rel_rot_deg']:.3f} deg "
        f"max {cmpres['max_rel_rot_deg']:.3f} deg"
    )
    assert rel_ate < 0.02, f"relative ATE {rel_ate:.3%}"
    assert cmpres["max_rel_rot_deg"] < 1.0

    # ---- oracle-vs-pipeline on >=8 views: the cv2+scipy
    # re-enactment of the reference stack sees the SAME images; with 8
    # cameras the sim(3) alignment is genuinely constrained (the 3-view
    # insel ATE is nearly guaranteed by DoF counting).
    import cv2

    from sfm_mvs_pipeline.utils.oracle import OracleConfig, oracle_reconstruct

    vpaths = sorted(str(p) for p in data.iterdir())
    orc = oracle_reconstruct(
        vpaths, OracleConfig(feature_limit=800),
        pairs=[(a, b) for a in range(8) for b in (a + 1, a + 2) if b < 8],
    )
    orc_rec = [int(s) for s in orc["recovered"]]
    common = sorted(set(int(s) for s in rec) & set(orc_rec))
    assert len(common) >= 7, f"oracle/pipeline common views {common}"
    ti = [list(rec).index(s) for s in common]
    oi = [orc_rec.index(s) for s in common]
    orc_C = np.asarray(orc["centers"])[oi]
    orc_R = np.stack([cv2.Rodrigues(orc["rvecs"][s])[0] for s in common])
    cmp_o = trajectory_compare(
        np.asarray(est_C)[ti], np.asarray(est_R)[ti], orc_C, orc_R
    )
    cmp_og = trajectory_compare(orc_C, orc_R, gt_C[common], gt_R[common])
    cmp_tg = trajectory_compare(
        np.asarray(est_C)[ti], np.asarray(est_R)[ti],
        gt_C[common], gt_R[common],
    )
    extent_c = np.linalg.norm(gt_C[common][-1] - gt_C[common][0])
    rel_o = cmp_o["ate_rmse"] / extent_c
    print(
        f"oracle-vs-pipeline ({len(common)} views): ATE {rel_o:.3%} of extent, "
        f"max rel rot {cmp_o['max_rel_rot_deg']:.3f} deg; "
        f"vs GT: oracle ATE {cmp_og['ate_rmse']/extent_c:.3%} "
        f"rot {cmp_og['max_rel_rot_deg']:.2f} deg, "
        f"pipeline ATE {cmp_tg['ate_rmse']/extent_c:.3%} "
        f"rot {cmp_tg['max_rel_rot_deg']:.2f} deg"
    )
    # the two stacks agree in position...
    assert rel_o < 0.02, f"oracle-vs-pipeline relative ATE {rel_o:.3%}"
    # ...and against the absolute truth this pipeline must be at least
    # as accurate as the reference re-enactment (this run: the oracle's
    # rotations are the outlier at ~4.5 deg, ours <1 deg — residual
    # rotation disagreement between the stacks is charged to the oracle)
    assert cmp_tg["ate_rmse"] <= cmp_og["ate_rmse"] * 1.5
    assert cmp_tg["max_rel_rot_deg"] <= max(cmp_og["max_rel_rot_deg"], 1.0)
