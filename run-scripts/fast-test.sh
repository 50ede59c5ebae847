#!/bin/bash
# Smoke test on the bundled 3-image insel dataset at trace loglevel —
# the twin of the reference's `build.sh fast-test` (ref: build.sh:233-239).
# Override the dataset with INSEL_IMAGES=<dir>.
set -e
cd "$(dirname "$0")/.."
IMAGES="${INSEL_IMAGES:-$(pwd)/sample_data/insel}"
OUT="${1:-out-fast-test}"
python -m sfm_mvs_pipeline -Ploglevel=0 -Prun=photogrammetrie \
    -Pimage="$IMAGES" -Pout="$OUT"
