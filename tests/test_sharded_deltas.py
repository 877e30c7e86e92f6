"""Sharded incremental re-stack: mutations must apply as per-shard row
deltas instead of a full re-stack, and the delta state must equal a
from-scratch rebuild."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from hnsw_tpu.core.spaces import L2Space
from hnsw_tpu.models.bruteforce import BruteforceIndex
from hnsw_tpu.parallel.sharding import ShardedHNSWIndex, build_sharded_arrays

pytestmark = pytest.mark.slow  # multi-minute builds on the CPU mesh

N, DIM = 3000, 32


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(23)
    x = rng.normal(size=(N, DIM)).astype(np.float32)
    q = x[rng.integers(0, N, 32)] + 0.01 * rng.normal(size=(32, DIM)).astype(
        np.float32
    )
    oracle = BruteforceIndex(L2Space(DIM))
    oracle.add_items(x, np.arange(N))
    _, gt = oracle.search_knn(q, 10)
    return x, q, gt


def _recall(got, gt):
    k = gt.shape[1]
    return np.mean([len(set(got[i]) & set(gt[i])) / k for i in range(len(gt))])


def _rebuild(idx, mesh):
    """Re-stack the arrays from scratch (the full-sync reference state)."""
    shards = [
        (b.export_graph(), b.export_vectors()) for b in idx._builders
    ]
    idx._arrays = build_sharded_arrays(shards, idx.space, mesh, "shard")
    for b in idx._builders:
        b.clear_dirty()
    idx._synced_n = [b.size for b in idx._builders]
    idx._pending_delta = False


def _build(x, mesh):
    idx = ShardedHNSWIndex("l2", DIM, mesh=mesh, m=8, ef_construction=100)
    idx.build(x)
    return idx


def test_incremental_delta(data):
    x, q, gt = data
    mesh = Mesh(np.array(jax.devices()), ("shard",))
    idx = _build(x, mesh)
    idx.search(q, k=10, ef=100)

    rng = np.random.default_rng(5)
    extra = rng.normal(size=(64, DIM)).astype(np.float32)
    idx.add_items(extra, np.arange(N, N + 64))
    d, labels = idx.search(extra, k=1, ef=150)
    assert idx.last_sync_mode == "delta", idx.last_sync_mode
    hit = (labels[:, 0] == np.arange(N, N + 64)).mean()
    assert hit >= 0.9, hit

    # in-place update routes to the owning shard and re-syncs as a delta
    upd = rng.normal(size=(8, DIM)).astype(np.float32)
    upd_labels = np.arange(100, 900, 100)
    idx.add_items(upd, upd_labels)
    d2, l2 = idx.search(upd, k=1, ef=150)
    assert idx.last_sync_mode == "delta", idx.last_sync_mode
    assert (l2[:, 0] == upd_labels).mean() >= 0.9

    # delta state must match a from-scratch rebuild
    d_delta, l_delta = idx.search(q, k=10, ef=150)
    _rebuild(idx, mesh)
    d_full, l_full = idx.search(q, k=10, ef=150)
    np.testing.assert_allclose(d_delta, d_full, rtol=1e-5)
    np.testing.assert_array_equal(l_delta, l_full)


def test_upper_growth_stays_delta(data):
    """Inserts that outgrow the stacked upper padding must still sync as a
    row delta: the small upper arrays grow (with headroom), the big vector /
    level-0 arrays are untouched."""
    x, q, gt = data
    mesh = Mesh(np.array(jax.devices()), ("shard",))
    idx = _build(x, mesh)
    idx.search(q, k=10, ef=100)
    u_pad_before = idx._arrays.upper.shape[2]

    rng = np.random.default_rng(11)
    # 4 waves of 256 (each under the oversized-delta cap, syncing between
    # waves): cumulative ~16 new upper nodes/shard at m=8 must outgrow the
    # stacked u_pad while every wave still syncs as a delta.
    base = N
    for _ in range(4):
        extra = rng.normal(size=(256, DIM)).astype(np.float32)
        idx.add_items(extra, np.arange(base, base + 256))
        d, labels = idx.search(extra[:64], k=1, ef=150)
        assert idx.last_sync_mode == "delta", idx.last_sync_mode
        hit = (labels[:, 0] == np.arange(base, base + 64)).mean()
        assert hit >= 0.9, hit
        base += 256
    assert idx._arrays.upper.shape[2] > u_pad_before, (
        idx._arrays.upper.shape, u_pad_before,
    )

    # delta state must match a from-scratch rebuild
    d_delta, l_delta = idx.search(q, k=10, ef=150)
    _rebuild(idx, mesh)
    d_full, l_full = idx.search(q, k=10, ef=150)
    np.testing.assert_allclose(d_delta, d_full, rtol=1e-5)
    np.testing.assert_array_equal(l_delta, l_full)


def test_delete_after_delta(data):
    x, q, gt = data
    mesh = Mesh(np.array(jax.devices()), ("shard",))
    idx = _build(x, mesh)
    idx.search(q, k=10, ef=100)
    victim = int(gt[0][0])
    idx.mark_deleted(victim)
    d, labels = idx.search(q, k=10, ef=150)
    assert victim not in set(labels.reshape(-1).tolist())
