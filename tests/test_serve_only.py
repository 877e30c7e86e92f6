"""A full re-sync after a mutation must not hold two copies of the device
arrays at once: `_full_sync` drops the old arrays, and the identity-keyed
landmark cache that still references them, before it allocates the new
ones."""

import numpy as np

DIM = 128
N = 2000


def _clustered(rng, n=N):
    centers = rng.normal(size=(64, DIM)).astype(np.float32)
    return centers[rng.integers(0, 64, n)] + 0.3 * rng.normal(
        size=(n, DIM)
    ).astype(np.float32)


def test_full_resync_releases_old_tables_first(rng, monkeypatch):
    """_full_sync drops self._device AND the identity-keyed landmark cache
    (which holds the old tuple) before allocating anything, so peak device
    memory during the re-sync is one index, not two."""
    import hnsw_tpu.models.hnsw as hnsw_mod
    from hnsw_tpu.models.hnsw import HNSWIndex

    x = _clustered(rng)
    idx = HNSWIndex("l2", dim=DIM, m=16, ef_construction=100)
    idx.add_items(x)
    # seeded search populates the landmark cache with the current arrays
    idx.search(x[:8], k=10, ef=50, entry_seeds=4)
    assert getattr(idx, "_landmark_cache", None) is not None

    seen = {}
    real = hnsw_mod.graph_device_arrays

    def spy(g, n_pad):
        seen["device_at_alloc"] = idx._device
        seen["lm_cache_at_alloc"] = getattr(idx, "_landmark_cache", None)
        return real(g, n_pad)

    monkeypatch.setattr(hnsw_mod, "graph_device_arrays", spy)
    # growth past the padded capacity forces a full re-sync
    idx.add_items(_clustered(rng, n=N // 8), np.arange(N, N + N // 8))
    idx._sync_device()
    assert idx._last_sync_mode == "full"
    assert seen["device_at_alloc"] is None
    assert seen["lm_cache_at_alloc"] is None
    d, l = idx.search(x[:8], k=1, ef=50)
    assert (l[:, 0] == np.arange(8)).all()
