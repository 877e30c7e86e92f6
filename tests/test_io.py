"""Serialization: .adj round-trip (reference format: index_builder/
build.cpp:14-21), native checkpoint round-trip, resume-after-load."""

import numpy as np

from hnsw_tpu.core.graph import check_integrity
from hnsw_tpu.io.adj import read_adj, write_adj
from hnsw_tpu.io.checkpoint import load_checkpoint, save_checkpoint
from hnsw_tpu.models.hnsw import HNSWIndex
from hnsw_tpu.native.hnsw_builder import NativeHNSWBuilder


def _build(n=800, dim=16, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    b = NativeHNSWBuilder(dim=dim, space="l2", m=8, ef_construction=100)
    b.add_batch(x, np.arange(n))
    return b, x


def test_adj_roundtrip(tmp_path):
    b, x = _build()
    g = b.export_graph()
    p = str(tmp_path / "g.adj")
    write_adj(g, p)
    g2 = read_adj(p)
    assert g2.num_nodes == g.num_nodes
    assert g2.entry_point == g.entry_point
    assert g2.max_level == g.max_level
    np.testing.assert_array_equal(g2.labels, g.labels)
    np.testing.assert_array_equal(g2.node_level, g.node_level)
    for node in range(g.num_nodes):
        for level in range(int(g.node_level[node]) + 1):
            np.testing.assert_array_equal(
                g2.neighbors(node, level), g.neighbors(node, level)
            )
    check_integrity(g2)


def test_adj_header_layout(tmp_path):
    """Byte-level check of the header the reference loader parses
    (hnsw_service/hnsw_graph.cpp:26-37)."""
    b, x = _build(n=50, dim=8)
    g = b.export_graph()
    p = str(tmp_path / "g.adj")
    write_adj(g, p)
    raw = np.fromfile(p, dtype="<u4")
    assert raw[0] == g.entry_point
    assert raw[1] == g.max_level
    assert raw[2] == 50
    assert raw[3] == g.labels[0]  # first node's label
    assert raw[4] == g.node_level[0] + 1  # levels count


def test_checkpoint_roundtrip(tmp_path):
    b, x = _build()
    g = b.export_graph()
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, g, x, meta={"space": "l2"})
    g2, x2, deleted, meta = load_checkpoint(p)
    np.testing.assert_array_equal(x2, x)
    np.testing.assert_array_equal(g2.level0, g.level0)
    np.testing.assert_array_equal(g2.upper, g.upper)
    assert meta["space"] == "l2"
    check_integrity(g2)


def test_index_save_load_resume(tmp_path):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(600, 12)).astype(np.float32)
    idx = HNSWIndex("l2", dim=12, m=8, ef_construction=100)
    idx.add_items(x)
    idx.mark_deleted(5)
    p = str(tmp_path / "idx.npz")
    idx.save(p)

    idx2 = HNSWIndex.load(p)
    assert idx2.num_elements == 600
    assert idx2._builder.num_deleted == 1
    # same search results
    q = x[:16]
    d1, l1 = idx.search(q, k=5, ef=64)
    d2, l2 = idx2.search(q, k=5, ef=64)
    np.testing.assert_array_equal(l1, l2)
    # resume: loaded index keeps accepting inserts
    extra = rng.normal(size=(50, 12)).astype(np.float32)
    idx2.add_items(extra, labels=np.arange(1000, 1050))
    assert idx2.num_elements == 650
    check_integrity(idx2.graph)
    d, l = idx2.search(extra[:4], k=1, ef=64)
    assert np.all(l[:, 0] == np.arange(1000, 1004))


def test_adj_import_searchable(tmp_path):
    """A graph loaded from .adj + external vectors must be directly
    searchable on device (the reference's optimized-mode capability:
    hnsw_service/hnsw_graph.cpp, minus the per-node HTTP fetches)."""
    import jax.numpy as jnp

    from hnsw_tpu.core.graph import graph_device_arrays, pad_vectors, round_up
    from hnsw_tpu.ops.traversal import search_batch

    b, x = _build(n=1000, dim=16)
    p = str(tmp_path / "g.adj")
    write_adj(b.export_graph(), p)
    g = read_adj(p)
    n_pad = round_up(g.num_nodes + 1, 128)
    dg = graph_device_arrays(g, n_pad)
    xv = jnp.asarray(pad_vectors(x, n_pad))
    res = search_batch(xv, dg, jnp.asarray(x[:8]), k=1, ef=32, space="l2")
    ids = np.asarray(res.ids)[:, 0]
    assert np.mean(ids == np.arange(8)) >= 0.9


def test_load_restores_every_init_attribute(tmp_path, rng):
    """HNSWIndex.load builds the object with __new__ and hand-sets state; a
    missed attribute only explodes on whatever (possibly device-only) path reads
    it, so pin the full attribute set structurally."""
    idx = HNSWIndex("l2", dim=16, m=8, ef_construction=50)
    idx.add_items(rng.normal(size=(64, 16)).astype(np.float32))
    p = str(tmp_path / "idx.npz")
    idx.save(p)
    idx2 = HNSWIndex.load(p)
    missing = set(idx.__dict__) - set(idx2.__dict__)
    assert not missing, f"load() misses attributes: {missing}"
    # scalar config must round-trip with the same values (a stale hardcoded
    # default in load() once silently downgraded the serving-table choice)
    for attr, v in idx.__dict__.items():
        if isinstance(v, (int, float, bool, str)) and not attr.startswith("_"):
            assert getattr(idx2, attr) == v, (attr, v, getattr(idx2, attr))


def test_native_adj_export_matches_numpy_writer(tmp_path):
    """The native streaming writer and the vectorized numpy writer must
    produce byte-identical files (reference format,
    index_builder/build.cpp:14-21)."""
    import numpy as np

    from hnsw_tpu.io.adj import write_adj
    from hnsw_tpu.models.hnsw import HNSWIndex

    rng = np.random.default_rng(5)
    x = rng.normal(size=(1500, 16)).astype(np.float32)
    idx = HNSWIndex("l2", dim=16, m=6, ef_construction=60)
    idx.add_items(x)
    p_native = str(tmp_path / "native.adj")
    p_numpy = str(tmp_path / "numpy.adj")
    idx.export_adj(p_native)
    write_adj(idx.graph, p_numpy)
    with open(p_native, "rb") as a, open(p_numpy, "rb") as b:
        assert a.read() == b.read()
