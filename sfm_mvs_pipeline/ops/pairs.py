"""Pair-generation policies: which image pairs get matched.

Purely index-math versions of the reference's three
IFeatureMatchingStrategy implementations:
  * unordered: all N(N-1)/2 pairs   (ref: src/photogrammetrie/sfm/UnorderedFeatureMatchingStrategy.cpp:33-37)
  * video: sliding window, each frame vs the next sequence_length-1 frames
           (ref: src/photogrammetrie/sfm/VideoFeatureMatchingStrategy.cpp:43-48)
  * grid: images laid out row-major on a 2D grid of row_length columns;
          pairs = triangular neighborhood offsets (di, dj) with
          di + dj < sequence_length, excluding self
          (ref: src/photogrammetrie/sfm/GridFeatureMatchingStrategy.cpp:44-85)

Each returns an (P, 2) int32 array of (left, right) shot indices with
left < right ordering by generation, plus the policy registry used by the CLI
(`-Pfeature-sequence` / `-Pfeature-gridlength`;
ref: src/cli/PhotogrammetrieCli.cpp:320-340).

The pair list is the data-parallel axis of the whole frontend: sharding it
over a device mesh is the moral equivalent of the reference's
`#pragma omp parallel for` over pairs.
"""

from __future__ import annotations

import numpy as np


def unordered_pairs(n_shots: int) -> np.ndarray:
    """All unordered pairs (i, j), i < j."""
    idx = np.triu_indices(n_shots, k=1)
    return np.stack([idx[0], idx[1]], axis=1).astype(np.int32)


def video_pairs(n_shots: int, sequence_length: int = 3) -> np.ndarray:
    """Sliding-window pairs: (i, i+d) for d in [1, sequence_length-1]."""
    pairs = [
        (i, i + d)
        for i in range(n_shots)
        for d in range(1, sequence_length)
        if i + d < n_shots
    ]
    return np.asarray(pairs, dtype=np.int32).reshape(-1, 2)


def grid_pairs(
    n_shots: int, row_length: int, sequence_length: int = 2
) -> np.ndarray:
    """Triangular grid-neighborhood pairs.

    Image k sits at (row, col) = (k // row_length, k % row_length); image k is
    paired with every in-grid image at offset (di, dj), di, dj >= 0,
    0 < di + dj < sequence_length (the reference iterates di in
    [0, sequence_length), dj in [0, sequence_length - di), skipping self;
    ref: GridFeatureMatchingStrategy.cpp:69-83).
    """
    pairs = []
    for k in range(n_shots):
        r, c = divmod(k, row_length)
        for di in range(sequence_length):
            for dj in range(sequence_length - di):
                if di == 0 and dj == 0:
                    continue
                r2, c2 = r + di, c + dj
                if c2 >= row_length:
                    continue
                k2 = r2 * row_length + c2
                if k2 >= n_shots:
                    continue
                pairs.append((k, k2))
    return np.asarray(pairs, dtype=np.int32).reshape(-1, 2)


def make_pairs(
    policy: str, n_shots: int, sequence_length: int = 3, row_length: int = 0
) -> np.ndarray:
    """Policy registry mirroring the CLI strategy selection."""
    if policy == "unordered":
        return unordered_pairs(n_shots)
    if policy in ("video", "sequence"):
        return video_pairs(n_shots, sequence_length)
    if policy == "grid":
        if row_length <= 0:
            raise ValueError("grid policy requires row_length > 0")
        return grid_pairs(n_shots, row_length, sequence_length)
    raise ValueError(f"unknown pair policy: {policy}")
