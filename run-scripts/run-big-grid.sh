#!/bin/bash
# Mirrors the reference experiment script of the same name
# (/root/reference/run-scripts/run-big-grid.sh).

echo "python -m sfm_mvs_pipeline --forceColoredOutput -Ploglevel=2 -Prun=photogrammetrie -Pimage=./images -Pout=./reconstruction -Pcamera-model=SimpleRadial -Pfeature-detector=SIFT -Pomp-feature-threads=8 -Pfeature-limit=0 -Pfeature-matcher=BF -Pfeature-sequence=$1 -Pfeature-gridlength=$2 --colored --dense --mesh --stats --artifacts" > run.log

python -m sfm_mvs_pipeline --forceColoredOutput -Ploglevel=2 -Prun=photogrammetrie -Pimage=./images -Pout=./reconstruction -Pcamera-model=SimpleRadial -Pfeature-detector=SIFT -Pomp-feature-threads=8 -Pfeature-limit=0 -Pfeature-matcher=BF -Pfeature-sequence=$1 -Pfeature-gridlength=$2 --colored --dense --mesh --stats --artifacts | tee out.log

./run-pcl-stats.sh
