#!/bin/bash
# Mirrors /root/reference/run-scripts/run-pcl-stats.sh

cd reconstruction

for CLOUD in pointcloud_sparse pointcloud_dense mesh_dense; do
  if [ -f "${CLOUD}.ply" ]; then
    echo "Write stats for ${CLOUD}"
    python -m sfm_mvs_pipeline -Prun=pcl-stats -Pinput=${CLOUD}.ply \
      -Pstats=${CLOUD}.stats.csv -Pneighbors=${CLOUD}.neighbors.csv \
      -Pquality=${CLOUD}.quality.ply
  fi
done

cd ..
