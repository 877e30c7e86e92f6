"""Exact uint8 storage tier — reference L2SpaceI parity
(hnswlib/space_l2.h:294-323, which stores uint8 losslessly at 1/4 the
float bytes).

The l2u8 space shifts values by -128 at insert/query time, so stored
vectors are integers in [-128, 127]: squared-L2 distances are unchanged,
every intermediate sum stays below 2^24 (exact in f32, and each shifted
value is exact in TF32 and bf16) — device-served distances must equal the
integer distances bit-for-bit, with or without the rescore pass.
"""

import numpy as np
import pytest

from hnsw_tpu.core.spaces import L2SpaceU8, get_space
from hnsw_tpu.models.bruteforce import BruteforceIndex
from hnsw_tpu.models.hnsw import HNSWIndex, SearchParams

DIM = 32
N = 2000


def _exact_dists(q, x, labels):
    qi = q.astype(np.int64)
    xi = x.astype(np.int64)
    out = np.full(labels.shape, -1.0)
    for i in range(labels.shape[0]):
        for j, lab in enumerate(labels[i]):
            if lab >= 0:
                out[i, j] = ((qi[i] - xi[lab]) ** 2).sum()
    return out


def _u8_data(rng):
    x = rng.integers(0, 256, size=(N, DIM)).astype(np.uint8)
    q = rng.integers(0, 256, size=(16, DIM)).astype(np.uint8)
    return x, q


@pytest.mark.parametrize("rescore", [0, 40])
def test_device_distances_bit_exact(rng, rescore):
    """The plain vector table serves the exact integer L2 distance for
    uint8 data, from the hop alone and through the exact rescore."""
    x, q = _u8_data(rng)
    idx = HNSWIndex("l2u8", dim=DIM, m=8, ef_construction=100)
    idx.add_items(x)
    # the stored table holds the shifted values exactly
    np.testing.assert_array_equal(
        np.asarray(idx.device_vectors)[:N],
        x.astype(np.int64) - 128,
    )

    d, l = idx.search(q, k=10, ef=200,
                      params=SearchParams(k=10, ef=200, rescore=rescore))
    ref = _exact_dists(q, x, l)
    valid = l >= 0
    assert valid.any()
    np.testing.assert_array_equal(d[valid].astype(np.float64), ref[valid])


@pytest.mark.slow
def test_recall_matches_oracle(rng):
    x, q = _u8_data(rng)
    idx = HNSWIndex("l2u8", dim=DIM, m=8, ef_construction=100)
    idx.add_items(x)
    bf = BruteforceIndex(L2SpaceU8(DIM))
    bf.add_items(x, np.arange(N))
    d_ref, l_ref = bf.search_knn(q, 10)
    _, l = idx.search(q, k=10, ef=200)
    rec = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(l, l_ref)])
    assert rec >= 0.95
    # oracle distances are the same exact integers
    ref = _exact_dists(q, x, l_ref)
    np.testing.assert_array_equal(d_ref.astype(np.float64), ref)


@pytest.mark.slow
def test_incremental_insert_stays_exact(rng):
    """Row-delta inserts keep the served distances exact too."""
    x, q = _u8_data(rng)
    idx = HNSWIndex("l2u8", dim=DIM, m=8, ef_construction=100)
    idx.add_items(x[: N - 100])
    idx.search(q, k=10, ef=200)
    idx.add_items(x[N - 100 :], np.arange(N - 100, N))
    d, l = idx.search(q, k=10, ef=200)
    assert idx._last_sync_mode == "delta"
    ref = _exact_dists(q, x, l)
    valid = l >= 0
    np.testing.assert_array_equal(d[valid].astype(np.float64), ref[valid])


def test_get_items_roundtrip(rng):
    x, _ = _u8_data(rng)
    idx = HNSWIndex("l2u8", dim=DIM)
    idx.add_items(x, np.arange(N))
    got = idx.get_items([3, 77, N - 1])
    np.testing.assert_array_equal(got, x[[3, 77, N - 1]].astype(np.float32))


@pytest.mark.slow
def test_persist_roundtrip(rng, tmp_path):
    x, q = _u8_data(rng)
    idx = HNSWIndex("l2u8", dim=DIM, m=8, ef_construction=100)
    idx.add_items(x, np.arange(N))
    p = str(tmp_path / "u8.npz")
    idx.save(p)
    idx2 = HNSWIndex.load(p)
    assert idx2.space.persist_name == "l2u8"
    d1, l1 = idx.search(q, k=10, ef=100)
    d2, l2 = idx2.search(q, k=10, ef=100)
    np.testing.assert_array_equal(l1, l2)
    np.testing.assert_array_equal(d1, d2)


@pytest.mark.slow
def test_bulk_build_recursive_upper_u8(rng):
    """Regression: bulk_build's recursive upper phase hands the sub-build
    ALREADY-preprocessed data, so it must pass the kernel-dispatch space
    (plain l2), not the user space — re-applying the non-idempotent l2u8
    shift raised 'l2u8 space requires values in [0, 255]' on any l2u8
    bulk build large enough to recurse."""
    from hnsw_tpu.models.bulk_build import bulk_build

    x, q = _u8_data(rng)
    idx = bulk_build(
        x, space="l2u8", m=8, ef_construction=100,
        first_wave=256, upper_recurse_min=50,
    )
    assert idx.space.persist_name == "l2u8"
    assert idx.num_elements == N
    d, l = idx.search(q, k=10, ef=200)
    ref = _exact_dists(q, x, l)
    valid = l >= 0
    assert valid.any()
    np.testing.assert_array_equal(d[valid].astype(np.float64), ref[valid])


def test_rejects_out_of_range():
    sp = get_space("l2u8", DIM)
    with pytest.raises(ValueError):
        sp.preprocess(np.full((1, DIM), 256.0, np.float32))
    with pytest.raises(ValueError):
        sp.preprocess(np.full((1, DIM), -1.0, np.float32))
    # integral floats in range are accepted
    out = sp.preprocess(np.full((1, DIM), 255.0, np.float32))
    assert (out == 127.0).all()
