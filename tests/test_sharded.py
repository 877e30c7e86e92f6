"""Sharded multi-device search on the virtual 8-device CPU mesh: recall vs
oracle, equivalence of merge, and 2D (dp, shard) mesh."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from hnsw_tpu.core.spaces import L2Space
from hnsw_tpu.models.bruteforce import BruteforceIndex
from hnsw_tpu.parallel.sharding import ShardedHNSWIndex

N, DIM = 4000, 32


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    x = rng.normal(size=(N, DIM)).astype(np.float32)
    q = x[rng.integers(0, N, 64)] + 0.01 * rng.normal(size=(64, DIM)).astype(
        np.float32
    )
    oracle = BruteforceIndex(L2Space(DIM))
    oracle.add_items(x, np.arange(N))
    _, gt = oracle.search_knn(q, 10)
    return x, q, gt


def _recall(got, gt):
    k = gt.shape[1]
    return np.mean([len(set(got[i]) & set(gt[i])) / k for i in range(len(gt))])


def test_sharded_recall_8way(data):
    x, q, gt = data
    mesh = Mesh(np.array(jax.devices()), ("shard",))
    idx = ShardedHNSWIndex("l2", DIM, mesh=mesh, m=16, ef_construction=200)
    idx.build(x)
    d, labels = idx.search(q, k=10, ef=100)
    r = _recall(labels, gt)
    assert r >= 0.95, f"sharded recall {r}"
    assert np.all(np.diff(d, axis=1) >= -1e-5)
    # every result label must be a real label
    assert labels.min() >= 0


def test_sharded_labels_cover_all_shards(data):
    x, q, gt = data
    mesh = Mesh(np.array(jax.devices()), ("shard",))
    idx = ShardedHNSWIndex("l2", DIM, mesh=mesh, m=8, ef_construction=100)
    idx.build(x)
    _, labels = idx.search(x[:256], k=1, ef=64)
    # self-query top-1: the hit lives on whichever shard owns that point,
    # so hits spanning all 8 residues proves cross-shard merge works
    assert _recall(labels, np.arange(256)[:, None]) >= 0.95
    assert len(set(labels[:, 0] % 8)) == 8


def test_sharded_2d_mesh(data):
    x, q, gt = data
    devs = np.array(jax.devices()).reshape(2, 4)
    mesh = Mesh(devs, ("dp", "shard"))
    idx = ShardedHNSWIndex(
        "l2", DIM, mesh=mesh, dp_axis="dp", m=16, ef_construction=200
    )
    idx.build(x)
    d, labels = idx.search(q, k=10, ef=100)
    assert _recall(labels, gt) >= 0.95


def test_sharded_matches_single(data):
    """Sharded search at equal ef should be >= single-index recall (each
    shard spends full ef on 1/S of the data)."""
    from hnsw_tpu.models.hnsw import HNSWIndex

    x, q, gt = data
    single = HNSWIndex("l2", dim=DIM, m=16, ef_construction=200)
    single.add_items(x)
    _, l1 = single.search(q, k=10, ef=64)
    mesh = Mesh(np.array(jax.devices()), ("shard",))
    idx = ShardedHNSWIndex("l2", DIM, mesh=mesh, m=16, ef_construction=200)
    idx.build(x)
    _, l8 = idx.search(q, k=10, ef=64)
    assert _recall(l8, gt) >= _recall(l1, gt) - 0.02


def test_sharded_save_load(tmp_path, data):
    x, q, gt = data
    mesh = Mesh(np.array(jax.devices()), ("shard",))
    idx = ShardedHNSWIndex("l2", DIM, mesh=mesh, m=8, ef_construction=100)
    idx.build(x)
    d1, l1 = idx.search(q, k=10, ef=64)
    prefix = str(tmp_path / "sharded")
    idx.save(prefix)

    idx2 = ShardedHNSWIndex("l2", DIM, mesh=mesh, m=8, ef_construction=100)
    idx2.load(prefix)
    d2, l2 = idx2.search(q, k=10, ef=64)
    np.testing.assert_array_equal(l1, l2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5)


@pytest.mark.slow
def test_sharded_filter_and_delete(data):
    """Single-chip parity on the sharded index (markDelete hnswalg.h:853-900,
    BaseFilterFunctor hnswlib.h:128-132): deleted labels never returned,
    filter masks restrict results."""
    x, q, gt = data
    mesh = Mesh(np.array(jax.devices()), ("shard",))
    idx = ShardedHNSWIndex("l2", DIM, mesh=mesh, m=8, ef_construction=100)
    idx.build(x)
    d0, l0 = idx.search(q, k=10, ef=100)
    victim = int(l0[0, 0])
    idx.mark_deleted(victim)
    d1, l1 = idx.search(q, k=10, ef=100)
    assert victim not in set(l1.ravel().tolist())
    idx.unmark_deleted(victim)
    d2, l2 = idx.search(q[:8], k=10, ef=100)
    assert victim in set(l2[0])
    # filter: only labels < 500 eligible
    mask = np.zeros(N, dtype=bool)
    mask[:500] = True
    d3, l3 = idx.search(q, k=5, ef=100, filter_labels=mask)
    valid = l3[l3 >= 0]
    assert len(valid) and (valid < 500).all()


def test_sharded_incremental_add(data):
    x, q, gt = data
    mesh = Mesh(np.array(jax.devices()), ("shard",))
    idx = ShardedHNSWIndex("l2", DIM, mesh=mesh, m=8, ef_construction=100)
    idx.build(x[:3000], np.arange(3000))
    extra = x[3000:3500]
    idx.add_items(extra, np.arange(3000, 3500))
    assert idx.num_elements == 3500
    # inserted points must be findable as their own nearest neighbor
    d, l = idx.search(extra[:32], k=1, ef=100)
    assert np.mean(l[:, 0] == np.arange(3000, 3032)) >= 0.9
    # shard balance maintained (round-robin to smallest shards)
    sizes = [b.size for b in idx._builders]
    assert max(sizes) - min(sizes) <= 1


def test_sharded_entry_override(data):
    x, q, gt = data
    mesh = Mesh(np.array(jax.devices()), ("shard",))
    idx = ShardedHNSWIndex("l2", DIM, mesh=mesh, m=8, ef_construction=100)
    idx.build(x)
    # entry override by external label: results should still be correct
    # (each shard maps the label locally or falls back to its entry point)
    ent = np.full(len(q), 7, dtype=np.int64)
    d, l = idx.search(q, k=10, ef=100, entry_labels=ent)
    assert _recall(l, gt) >= 0.9


def test_sharded_speed_mode(data):
    """Speed-mode knobs on the sharded path match single-chip SearchParams:
    frontier stop + lockstep hop budget keep recall within noise of the
    exhaustive beam, and a brutally small budget degrades recall (proof the
    cap is live in the shard-local loop)."""
    x, q, gt = data
    mesh = Mesh(np.array(jax.devices()), ("shard",))
    idx = ShardedHNSWIndex("l2", DIM, mesh=mesh, m=16, ef_construction=200)
    idx.build(x)
    _, l_ex = idx.search(q, k=10, ef=100)
    _, l_sp = idx.search(q, k=10, ef=100, stop_frontier=1.15, max_iters=24)
    assert _recall(l_sp, gt) >= _recall(l_ex, gt) - 0.02
    _, l_tiny = idx.search(q, k=10, ef=100, max_iters=2)
    assert _recall(l_tiny, gt) < _recall(l_ex, gt)


@pytest.mark.slow
def test_sharded_entry_seeds(data):
    """Landmark-seeded entry (SearchParams.entry_seeds parity): per-shard
    seed matmul replaces the greedy descent with recall within noise of the
    descent path, composes with the speed-mode budget, and works on the 2D
    (dp, shard) mesh. With a tiny hop budget seeds must BEAT the descent
    (the seeded beam starts at the exact top-S landmarks, proof the seeds
    are live)."""
    x, q, gt = data
    mesh = Mesh(np.array(jax.devices()), ("shard",))
    idx = ShardedHNSWIndex("l2", DIM, mesh=mesh, m=16, ef_construction=200)
    idx.build(x)
    _, l_desc = idx.search(q, k=10, ef=100)
    _, l_seed = idx.search(q, k=10, ef=100, entry_seeds=4)
    assert _recall(l_seed, gt) >= _recall(l_desc, gt) - 0.02
    _, l_seed_fast = idx.search(
        q, k=10, ef=100, entry_seeds=4, stop_frontier=1.15, max_iters=24
    )
    assert _recall(l_seed_fast, gt) >= _recall(l_desc, gt) - 0.03
    # landmark cache keys on the arrays object
    assert idx._landmark_cache[0] is idx.arrays
    # seed_pool (strided level-0 landmarks) is a superset pool: recall must
    # hold and the per-shard landmark count must grow
    lm_plain = idx._landmarks_for(idx.arrays)
    lm_pool = idx._landmarks_for(idx.arrays, pool_extra=64)
    n_plain = int(np.sum(np.asarray(lm_plain[1]) >= 0, axis=1).min())
    n_pool = int(np.sum(np.asarray(lm_pool[1]) >= 0, axis=1).min())
    assert n_pool == n_plain + 64, (n_plain, n_pool)
    _, l_pool = idx.search(q, k=10, ef=100, entry_seeds=4, seed_pool=64)
    assert _recall(l_pool, gt) >= _recall(l_seed, gt) - 0.02
    # seeds survive a mutation re-sync (fresh arrays -> fresh landmarks)
    idx.add_items(x[:8] + 0.5, labels=np.arange(N, N + 8))
    _, l_after = idx.search(q, k=10, ef=100, entry_seeds=4)
    assert _recall(l_after, gt) >= _recall(l_desc, gt) - 0.02
    assert idx._landmark_cache[0] is idx.arrays


def test_sharded_entry_seeds_2d_mesh(data):
    x, q, gt = data
    devs = np.array(jax.devices()).reshape(2, 4)
    mesh = Mesh(devs, ("dp", "shard"))
    idx = ShardedHNSWIndex(
        "l2", DIM, mesh=mesh, dp_axis="dp", m=16, ef_construction=200
    )
    idx.build(x)
    _, labels = idx.search(q, k=10, ef=100, entry_seeds=4)
    assert _recall(labels, gt) >= 0.95
