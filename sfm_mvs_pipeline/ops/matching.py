"""Descriptor matching: batched 2-NN with Lowe ratio test.

Batched replacement for the reference's cv::DescriptorMatcher::knnMatch
loop over image pairs (ref: src/photogrammetrie/sfm/UnorderedFeatureMatchingStrategy.cpp:50-65):
k=2 brute-force / FLANN matching + ratio filter 0.7, then a minimum match
count and an optional "distinct matches" filter
(ref: src/photogrammetrie/sfm/SfM.cpp:547-570).

Design:
  * distances are matrix products: ||q||^2 + ||t||^2 - 2 q.t (L2-squared),
    with binary descriptors expanded to +-1 vectors so Hamming distance is
    an affine function of the same dot product (ham = (bits - dot)/2; both
    are monotone in -dot so the SAME kernel serves SIFT-L2 and ORB-Hamming).
  * fixed feature capacity F with validity masks instead of ragged lists.
  * XLA compiles the distance product and the top-2; a Pallas kernel that
    kept a running top-2 instead was 6-11x faster at the layer on an H100
    but no faster end to end (PERF.md, "Kernel decisions").

Ratio-test note: OpenCV applies `d1 < ratio * d2` on UN-squared L2 distance
and on raw Hamming counts. We compute squared-L2, so the L2 test becomes
`sq1 < ratio^2 * sq2`; the +-1 Hamming expansion gives 4*ham which preserves
`ham1 < ratio * ham2` exactly.
"""

from __future__ import annotations

import functools
from typing import Literal

import jax
import jax.numpy as jnp
import numpy as np

_BIG = jnp.float32(3.0e38)


def expand_binary_descriptors(desc_u8: jax.Array) -> jax.Array:
    """uint8 binary descriptors (..., B) -> +-1 float (..., 8B).

    Hamming distance between rows a, b == (8B - dot(a_pm, b_pm)) / 2, and the
    generic squared-L2 pipeline computes |a-b|^2 = 4 * hamming — monotone and
    ratio-preserving, so no separate Hamming kernel is needed: the matrix
    product does the popcount.
    """
    bits = jnp.unpackbits(desc_u8, axis=-1, bitorder="little")
    return bits.astype(jnp.float32) * 2.0 - 1.0


def _sq_distance_matrix(desc_q: jax.Array, desc_t: jax.Array) -> jax.Array:
    """Squared L2 distances (Fq, Ft) via the matmul identity."""
    # norms accumulate in f32 even for bf16 descriptors (the +-1 Hamming
    # expansion arrives as bf16, exact for +-1 values)
    qf = desc_q.astype(jnp.float32)
    tf = desc_t.astype(jnp.float32)
    qn = jnp.sum(qf * qf, axis=-1)
    tn = jnp.sum(tf * tf, axis=-1)
    dot = jnp.dot(desc_q, desc_t.T, preferred_element_type=jnp.float32)
    d = qn[:, None] + tn[None, :] - 2.0 * dot
    return jnp.maximum(d, 0.0)


def two_nn_jnp(
    desc_q: jax.Array,
    desc_t: jax.Array,
    valid_q: jax.Array,
    valid_t: jax.Array,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Reference 2-NN: returns (best_idx (Fq,), best_sq (Fq,), second_sq (Fq,))."""
    d = _sq_distance_matrix(desc_q, desc_t)
    d = jnp.where(valid_t[None, :], d, _BIG)
    neg_top2, idx_top2 = jax.lax.top_k(-d, 2)
    best_idx = idx_top2[:, 0]
    best = -neg_top2[:, 0]
    second = -neg_top2[:, 1]
    best = jnp.where(valid_q, best, _BIG)
    return best_idx, best, second


def two_nn_approx(
    desc_q: jax.Array,
    desc_t: jax.Array,
    valid_q: jax.Array,
    valid_t: jax.Array,
    proj_dim: int = 16,
    shortlist: int = 32,
    seed: int = 7,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Approximate 2-NN — the stand-in for the reference's FLANN matcher
    option (KDTree/LSH; ref: src/cli/PhotogrammetrieCli.cpp:366-383).

    Trees and hash probes serialize badly on an accelerator; the equivalent
    accuracy/speed trade ("cascade hashing" family, cf. PAPERS.md) stays in
    matrix products: (1) project descriptors to `proj_dim` dims with a fixed
    seeded random rotation, (2) shortlist `shortlist` candidates per query
    from the cheap low-dim distances, (3) exact distances on the shortlist
    only. Cost drops ~D/proj_dim for the sweep + shortlist/F for the rerank.
    """
    d = desc_q.shape[1]
    key = jax.random.key(seed)
    R = jax.random.normal(key, (d, proj_dim), dtype=jnp.float32) / np.sqrt(d)
    pq = desc_q.astype(jnp.float32) @ R
    pt = desc_t.astype(jnp.float32) @ R

    dlow = _sq_distance_matrix(pq, pt)
    dlow = jnp.where(valid_t[None, :], dlow, _BIG)
    _, cand = jax.lax.top_k(-dlow, shortlist)  # (Fq, S)

    # exact rerank on the shortlist
    dt_c = desc_t[cand]  # (Fq, S, D)
    qn = jnp.sum(desc_q * desc_q, axis=-1)
    tn = jnp.sum(dt_c * dt_c, axis=-1)
    dot = jnp.einsum(
        "fd,fsd->fs", desc_q, dt_c, preferred_element_type=jnp.float32
    )
    dist = jnp.maximum(qn[:, None] + tn - 2.0 * dot, 0.0)
    dist = jnp.where(valid_t[cand], dist, _BIG)
    neg2, idx2 = jax.lax.top_k(-dist, 2)
    best_idx = jnp.take_along_axis(cand, idx2[:, :1], axis=1)[:, 0]
    best = jnp.where(valid_q, -neg2[:, 0], _BIG)
    second = -neg2[:, 1]
    return best_idx, best, second


def ratio_test_mask(
    best_sq: jax.Array,
    second_sq: jax.Array,
    valid_q: jax.Array,
    ratio: float = 0.7,
) -> jax.Array:
    """Lowe ratio on squared distances: d1 < ratio^2 * d2.

    (ref ratio 0.7 on unsquared distances:
    UnorderedFeatureMatchingStrategy.cpp:60-65)
    """
    return (best_sq < (ratio * ratio) * second_sq) & valid_q & (best_sq < _BIG)


def distinct_filter(best_idx: jax.Array, match_mask: jax.Array) -> jax.Array:
    """Drop matches whose target index is claimed by more than one query.

    Mirrors the reference's O(M^2) distinct-feature-match test
    (ref: src/photogrammetrie/sfm/SfM.cpp:547-564) as an O(F) scatter:
    count queries per target, keep matches whose target has count == 1.
    """
    # Fixed feature capacity F is shared by query and target sides, so a
    # length-F count buffer covers every possible target index.
    counts = jnp.zeros((best_idx.shape[0],), dtype=jnp.int32)
    counts = counts.at[best_idx].add(match_mask.astype(jnp.int32), mode="drop")
    claimed_once = counts[best_idx] == 1
    return match_mask & claimed_once


def match_pair(
    desc_q: jax.Array,
    desc_t: jax.Array,
    valid_q: jax.Array,
    valid_t: jax.Array,
    ratio: float = 0.7,
    distinct: bool = False,
    method: Literal["bf", "flann"] = "bf",
    with_distance: bool = False,
    exact: bool = False,
) -> tuple[jax.Array, ...]:
    """Match one descriptor set against another.

    Returns (best_idx (Fq,) int32, mask (Fq,) bool): query i matches target
    best_idx[i] where mask[i]. Matches the semantics of the reference's
    knnMatch + ratio(0.7) (+ optional distinct filter). method="flann"
    selects the approximate shortlist path (two_nn_approx).

    with_distance=True appends the best L2 distance (Fq,) — the analogue of
    cv::DMatch::distance, used by the track-fusion merge gate
    (`-Ppointcloud-feature-merge-distance`; ref Scene.cpp:532).

    Precision (-Pmatch-precision): fast (default) takes bf16 operands with
    f32 accumulation. That is exact on integer descriptors up to 256, which
    is what both extractors emit (ops/sift.py rounds to [0, 255] like cv2;
    ORB arrives as the +-1 Hamming expansion), and rounds each element of
    other float descriptors by up to 2^-9 relative. exact=True takes f32
    operands at the global "highest" precision (no TF32).
    """
    if method == "flann":
        best_idx, best_sq, second_sq = two_nn_approx(
            desc_q, desc_t, valid_q, valid_t
        )
    else:
        op = jnp.float32 if exact else jnp.bfloat16
        best_idx, best_sq, second_sq = two_nn_jnp(
            desc_q.astype(op), desc_t.astype(op), valid_q, valid_t
        )
    mask = ratio_test_mask(best_sq, second_sq, valid_q, ratio)
    if distinct:
        mask = distinct_filter(best_idx, mask)
    if with_distance:
        return best_idx, mask, jnp.sqrt(jnp.maximum(best_sq, 0.0))
    return best_idx, mask


@functools.partial(
    jax.jit,
    static_argnames=(
        "ratio", "distinct", "chunk", "method", "with_distance", "exact",
    ),
)
def match_pairs_batch(
    descriptors: jax.Array,  # (S, F, D)
    valid: jax.Array,  # (S, F) bool
    pairs: jax.Array,  # (P, 2) int32
    ratio: float = 0.7,
    distinct: bool = False,
    chunk: int = 8,
    method: Literal["bf", "flann"] = "bf",
    with_distance: bool = False,
    exact: bool = False,
) -> tuple[jax.Array, ...]:
    """Match every (left, right) pair in `pairs`.

    Returns (best_idx (P, F), mask (P, F)). The P axis is the framework's
    data-parallel axis (shard it over the mesh; parallel/matching.py), the
    equivalent of the reference's OMP-parallel pair loop
    (UnorderedFeatureMatchingStrategy.cpp:40). Pairs run through lax.map
    in chunks, so chunk * F^2 f32 distances are live at once.
    """

    def one(pair):
        return match_pair(
            descriptors[pair[0]], descriptors[pair[1]], valid[pair[0]],
            valid[pair[1]], ratio=ratio, distinct=distinct, method=method,
            with_distance=with_distance, exact=exact,
        )

    return jax.lax.map(one, pairs, batch_size=chunk)


def min_match_count_filter(
    pair_masks: jax.Array, min_count: int = 20
) -> jax.Array:
    """Per-pair validity: at least min_count surviving matches.

    (ref `-Pmatch-threshold` default 20; SfM.cpp:566-570)
    """
    return jnp.sum(pair_masks, axis=-1) >= min_count


def matches_to_numpy(
    best_idx: np.ndarray, mask: np.ndarray
) -> list[np.ndarray]:
    """Convert one pair's fixed-capacity match arrays to a compact
    (M, 2) [queryIdx, trainIdx] list — host-side convenience for exports."""
    out = []
    for bi, m in zip(best_idx, mask):
        q = np.nonzero(m)[0]
        out.append(np.stack([q, bi[q]], axis=1).astype(np.int32))
    return out
