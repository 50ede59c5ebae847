#!/bin/bash
# Mirrors the reference experiment script of the same name
# (/root/reference/run-scripts/run-orb-unordered.sh).

echo "python -m sfm_mvs_pipeline --forceColoredOutput -Ploglevel=2 -Prun=photogrammetrie -Pimage=./images -Pout=./reconstruction -Pcamera-model=SimpleRadial -Pfeature-detector=ORB -Pfeature-limit=0 -Pomp-feature-threads=8 -Pfeature-matcher=BF --colored --dense --mesh --stats --artifacts" > run.log

python -m sfm_mvs_pipeline --forceColoredOutput -Ploglevel=2 -Prun=photogrammetrie -Pimage=./images -Pout=./reconstruction -Pcamera-model=SimpleRadial -Pfeature-detector=ORB -Pfeature-limit=0 -Pomp-feature-threads=8 -Pfeature-matcher=BF --colored --dense --mesh --stats --artifacts | tee out.log

./run-pcl-stats.sh
