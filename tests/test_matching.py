"""Matching stack vs OpenCV BFMatcher oracle + fast/exact precision modes."""

import numpy as np
import cv2
import jax
import jax.numpy as jnp
import pytest

from sfm_mvs_pipeline.ops import matching as M
from sfm_mvs_pipeline.ops import pairs as PR


def _rand_desc(rng, n, d=128):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return np.abs(x)


def test_two_nn_vs_bfmatcher(rng):
    dq = _rand_desc(rng, 300)
    dt = _rand_desc(rng, 250)
    # make some true matches so the ratio test passes sometimes
    dt[:100] = dq[:100] + rng.normal(size=(100, 128)).astype(np.float32) * 0.01

    valid_q = np.ones(300, bool)
    valid_t = np.ones(250, bool)
    bi, bsq, ssq = M.two_nn_jnp(
        jnp.asarray(dq), jnp.asarray(dt), jnp.asarray(valid_q), jnp.asarray(valid_t)
    )
    mask = M.ratio_test_mask(bsq, ssq, jnp.asarray(valid_q), ratio=0.7)

    bf = cv2.BFMatcher(cv2.NORM_L2)
    knn = bf.knnMatch(dq, dt, k=2)
    cv_pass = {}
    for m2 in knn:
        if len(m2) == 2 and m2[0].distance < 0.7 * m2[1].distance:
            cv_pass[m2[0].queryIdx] = m2[0].trainIdx

    ours = {int(q): int(bi[q]) for q in np.nonzero(np.asarray(mask))[0]}
    assert ours == cv_pass


def test_hamming_expansion_matches_cv(rng):
    dq = rng.integers(0, 256, size=(100, 32), dtype=np.uint8)
    dt = rng.integers(0, 256, size=(120, 32), dtype=np.uint8)
    dt[:40] = dq[:40]
    for i in range(40):  # flip a few bits
        dt[i, i % 32] ^= 3

    eq = M.expand_binary_descriptors(jnp.asarray(dq))
    et = M.expand_binary_descriptors(jnp.asarray(dt))
    bi, bsq, ssq = M.two_nn_jnp(
        eq, et, jnp.ones(100, bool), jnp.ones(120, bool)
    )
    # |a-b|^2 = 4 * hamming
    bf = cv2.BFMatcher(cv2.NORM_HAMMING)
    knn = bf.knnMatch(dq, dt, k=2)
    for q, m2 in enumerate(knn):
        assert int(bi[q]) == m2[0].trainIdx
        assert float(bsq[q]) == pytest.approx(4.0 * m2[0].distance)
        assert float(ssq[q]) == pytest.approx(4.0 * m2[1].distance)


def _int_desc(rng, shape):
    # uint8-range integers: exact in bf16, every sum below 2^24
    return rng.integers(0, 256, size=shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["sift", "orb"])
def test_fast_mode_exact_on_integer_descriptors(rng, kind):
    """fast mode (bf16 operands, f32 accumulation) gives the f32 reference's
    neighbours, distances and masks bit for bit on uint8-range SIFT and on
    the +-1 ORB expansion."""
    if kind == "sift":
        dq, dt = _int_desc(rng, (300, 128)), _int_desc(rng, (280, 128))
        dt[:90] = np.clip(dq[:90] + rng.integers(-4, 5, (90, 128)), 0, 255)
    else:
        u = rng.integers(0, 256, size=(580, 32), dtype=np.uint8)
        e = np.asarray(M.expand_binary_descriptors(jnp.asarray(u)))
        dq, dt = e[:300], e[300:]
    vq = jnp.asarray(np.arange(300) < 290)
    vt = jnp.asarray(np.arange(280) < 270)
    bi_j, b_j, s_j = M.two_nn_jnp(jnp.asarray(dq), jnp.asarray(dt), vq, vt)
    m_j = np.asarray(M.ratio_test_mask(b_j, s_j, vq))
    bi, m, dist = M.match_pair(jnp.asarray(dq), jnp.asarray(dt), vq, vt,
                               with_distance=True)
    np.testing.assert_array_equal(np.asarray(m), m_j)
    np.testing.assert_array_equal(np.asarray(bi)[:290], np.asarray(bi_j)[:290])
    np.testing.assert_array_equal(
        np.asarray(dist)[m_j], np.sqrt(np.asarray(b_j))[m_j]
    )


def test_fast_mode_exact_on_extracted_sift():
    """The SIFT extractor emits cv2-convention integers in [0, 255], so fast
    mode matches the bundled insel frames exactly as exact mode does."""
    import os

    from sfm_mvs_pipeline.ops.sift import sift_features
    from sfm_mvs_pipeline.utils.images import list_images, load_gray_batch

    insel = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "sample_data", "insel")
    imgs, _ = load_gray_batch(list_images(insel))
    feats = sift_features(jnp.asarray(imgs), max_features=1024,
                          contrast_threshold=0.09)
    descs = np.asarray(feats["descriptors"])
    valid = np.asarray(feats["valid"])
    assert valid.sum() > 300
    d = descs[valid]
    np.testing.assert_array_equal(d, np.round(d))
    assert d.min() >= 0 and d.max() <= 255 and d.max() > 100
    pairs = jnp.asarray(PR.unordered_pairs(len(imgs)))
    fast = M.match_pairs_batch(jnp.asarray(descs), jnp.asarray(valid), pairs,
                               with_distance=True)
    exact = M.match_pairs_batch(jnp.asarray(descs), jnp.asarray(valid), pairs,
                                with_distance=True, exact=True)
    assert np.asarray(fast[1]).sum() > 50
    for a, b in zip(fast, exact):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_exact_mode_matches_reference(rng):
    """exact=True keeps f32 operands: on float descriptors the matches and
    distances are the f32 reference's."""
    dq = jnp.asarray(_rand_desc(rng, 300))
    dt = jnp.asarray(_rand_desc(rng, 280))
    vq = jnp.ones(300, bool)
    vt = jnp.ones(280, bool)
    bi_j, b_j, s_j = M.two_nn_jnp(dq, dt, vq, vt)
    bi, m, dist = M.match_pair(dq, dt, vq, vt, exact=True, with_distance=True)
    m_j = np.asarray(M.ratio_test_mask(b_j, s_j, vq))
    np.testing.assert_array_equal(np.asarray(m), m_j)
    np.testing.assert_array_equal(np.asarray(bi), np.asarray(bi_j))
    np.testing.assert_array_equal(np.asarray(dist), np.sqrt(np.asarray(b_j)))


@pytest.mark.gpu
def test_matcher_precision_on_gpu(rng):
    """On the card, the f32 reference runs at full precision (the package
    sets "highest", so no TF32) and fast mode equals it on integer
    descriptors. Runs only where JAX's backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: checks the card's matmul precision")
    S, F = 4, 3000
    descs = jnp.asarray(_int_desc(rng, (S, F, 128)))
    valid = jnp.asarray(rng.random((S, F)) > 0.05)
    pairs = jnp.asarray(PR.unordered_pairs(S))
    fast = M.match_pairs_batch(descs, valid, pairs, with_distance=True)
    exact = M.match_pairs_batch(descs, valid, pairs, with_distance=True,
                                exact=True)
    for a, b in zip(fast, exact):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    d = np.asarray(descs, np.float64)
    for k, (a, b) in enumerate(np.asarray(pairs)):
        sq = ((d[a][:, None] - d[b][None]) ** 2).sum(-1)
        sq[:, ~np.asarray(valid[b])] = np.inf
        m = np.asarray(exact[1][k])
        np.testing.assert_array_equal(np.asarray(exact[0][k])[m],
                                      sq.argmin(1)[m])
        np.testing.assert_allclose(np.asarray(exact[2][k], np.float64)[m] ** 2,
                                   sq.min(1)[m], rtol=1e-6)


def test_distinct_filter():
    best_idx = jnp.asarray([2, 2, 1, 3], dtype=jnp.int32)
    mask = jnp.asarray([True, True, True, False])
    out = np.asarray(M.distinct_filter(best_idx, mask))
    # target 2 claimed twice -> both dropped; 1 once -> kept; last masked out
    assert list(out) == [False, False, True, False]


def test_match_pairs_batch(rng):
    S, F, D = 4, 64, 32
    descs = np.abs(rng.normal(size=(S, F, D))).astype(np.float32)
    descs[1, :32] = descs[0, :32] + 0.001 * rng.normal(size=(32, D)).astype(np.float32)
    valid = np.ones((S, F), bool)
    pairs = PR.unordered_pairs(S)
    bi, mask = M.match_pairs_batch(
        jnp.asarray(descs), jnp.asarray(valid), jnp.asarray(pairs)
    )
    assert bi.shape == (len(pairs), F)
    m01 = np.asarray(mask[0])
    assert m01[:32].sum() >= 30  # the planted matches survive


def test_pair_policies():
    assert len(PR.unordered_pairs(5)) == 10
    v = PR.video_pairs(5, sequence_length=3)
    assert [tuple(p) for p in v] == [
        (0, 1), (0, 2), (1, 2), (1, 3), (2, 3), (2, 4), (3, 4),
    ]
    g = PR.grid_pairs(6, row_length=3, sequence_length=2)
    # 2x3 grid: right-neighbor + down-neighbor pairs
    expected = {(0, 1), (1, 2), (3, 4), (4, 5), (0, 3), (1, 4), (2, 5)}
    assert {tuple(p) for p in g} == expected
