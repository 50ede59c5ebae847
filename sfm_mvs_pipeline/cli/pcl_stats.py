"""pcl-stats subcommand: NN-distance statistics for a PLY point cloud.

Parity with PclStatsCli (ref: src/cli/PclStatsCli.cpp:30-65):
loads a PLY, writes `<stats>.csv` (NN-distance stats), `<neighbors>.csv`
(histogram), `<quality>.ply` (quality-colored cloud).
"""

from __future__ import annotations

import os

from sfm_mvs_pipeline.utils.args import AppArgs
from sfm_mvs_pipeline.utils import logger as logging

log = logging.AppLogger("PclStatsCli")


def print_usage() -> None:
    print(
        """pcl-stats — point cloud nearest-neighbor statistics

  -Pinput=<file.ply>      input cloud (default pointcloud.ply)
  -Pstats=<file.csv>      stats output (default <input>.stats.csv)
  -Pneighbors=<file.csv>  histogram output (default <input>.neighbors.csv)
  -Pquality=<file.ply>    quality-colored cloud (default <input>.quality.ply)
  --help"""
    )


def main(args: AppArgs) -> int:
    if args.is_flag("help"):
        print_usage()
        return 0

    from sfm_mvs_pipeline.utils.ply import read_ply, write_ply_points
    from sfm_mvs_pipeline.utils.stats import (
        _write_histogram_csv,
        _write_stats_csv,
        calculate_statistics,
        knn_distances,
    )
    import numpy as np

    inp = args.get("input", "pointcloud.ply")
    base = os.path.splitext(inp)[0]
    data = read_ply(inp)
    pts = data.get("points")
    if pts is None or len(pts) == 0:
        log.error(f"no points in {inp}")
        return 1
    log.info(f"{len(pts)} points loaded from {inp}")

    d = knn_distances(pts)
    st = calculate_statistics(d)
    stats_out = args.get("stats", base + ".stats.csv")
    _write_stats_csv(stats_out, st, os.path.basename(base))
    log.info(f"NN distance: mean {st['mean']:.4f} median {st['median']:.4f}")

    neigh_out = args.get("neighbors", base + ".neighbors.csv")
    res = st["variance"] if st["variance"] > 0 else 1.0
    _write_histogram_csv(neigh_out, d, res)

    quality_out = args.get("quality", base + ".quality.ply")
    if len(d):
        t = (d - d.min()) / max(d.max() - d.min(), 1e-12)
        colors = np.stack(
            [
                (t * 255).astype(np.uint8),
                np.zeros(len(d), np.uint8),
                ((1 - t) * 255).astype(np.uint8),
            ],
            axis=1,
        )
        faces = data.get("faces")
        if faces is not None and len(faces):
            # meshes keep their faces in the quality PLY, like the
            # reference's writeToNeighborPLY (PclUtils.cpp:91-265)
            from sfm_mvs_pipeline.utils.ply import write_ply_mesh

            write_ply_mesh(quality_out, pts, faces, colors=colors)
        else:
            write_ply_points(quality_out, pts, colors)
    log.info("done")
    return 0
