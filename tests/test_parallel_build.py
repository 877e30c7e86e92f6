"""Concurrent bulk insert (per-node striped link locks, reference semantics
of concurrent addPoint: hnswalg.h:43,255,529-555).

NOTE on what these tests can and cannot observe: this host has ONE CPU
core, so n_threads=4 exercises the threaded code paths and their
invariants (graph integrity, recall, determinism of the serial path) but
cannot produce real lock contention or interleaving. Actual race coverage
comes from the ThreadSanitizer stress harness (`bin/tsan_check.py`,
`native/tsan_stress.cpp`) whose clean run is committed as
res/tsan_builder.log — including the grow-lock reader-drain design."""

import numpy as np

from hnsw_tpu.core.graph import check_integrity
from hnsw_tpu.core.spaces import L2Space
from hnsw_tpu.models.bruteforce import BruteforceIndex
from hnsw_tpu.native.hnsw_builder import NativeHNSWBuilder

N, DIM = 20000, 32  # past the builder's 4096-node serial prefix


def _build(n_threads):
    rng = np.random.default_rng(42)
    x = rng.normal(size=(N, DIM)).astype(np.float32)
    b = NativeHNSWBuilder(dim=DIM, space="l2", m=16, ef_construction=100)
    b.add_batch(x, np.arange(N), n_threads=n_threads)
    return b, x


def test_parallel_build_integrity_and_recall():
    b, x = _build(n_threads=4)
    assert b.size == N
    g = b.export_graph()
    check_integrity(g, require_inbound=False)
    oracle = BruteforceIndex(L2Space(DIM))
    oracle.add_items(x, np.arange(N))
    q = x[:100]
    _, gt = oracle.search_knn(q, 10)
    _, got, _ = b.search_batch(q, 10, ef=100)
    recall = np.mean([len(set(got[i]) & set(gt[i])) / 10 for i in range(100)])
    assert recall >= 0.95, recall


def test_parallel_matches_serial_quality():
    bp, x = _build(n_threads=4)
    bs, _ = _build(n_threads=1)
    oracle = BruteforceIndex(L2Space(DIM))
    oracle.add_items(x, np.arange(N))
    q = x[100:200]
    _, gt = oracle.search_knn(q, 10)

    def recall(b):
        _, got, _ = b.search_batch(q, 10, ef=64)
        return np.mean([len(set(got[i]) & set(gt[i])) / 10 for i in range(100)])

    rp, rs = recall(bp), recall(bs)
    assert rp >= rs - 0.03, (rp, rs)


def test_batch_with_duplicate_labels_updates():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(200, DIM)).astype(np.float32)
    b = NativeHNSWBuilder(dim=DIM, space="l2", m=8, ef_construction=50)
    b.add_batch(x, np.arange(200), n_threads=2)
    # second batch overlaps labels 100..199 with new vectors
    y = rng.normal(size=(150, DIM)).astype(np.float32)
    b.add_batch(y, np.arange(100, 250), n_threads=2)
    assert b.size == 250
    d, l = b.search(y[0], k=1, ef=50)
    assert l[0] == 100 and d[0] < 1e-3
    check_integrity(b.export_graph(), require_inbound=False)


def test_threaded_build_leaves_no_orphans():
    """The threaded link phase can prune a node out of every list that held
    it; the repair pass after it must re-attach each such node, so every
    node keeps an inbound level-0 edge."""
    b, _ = _build(n_threads=4)
    check_integrity(b.export_graph(), require_inbound=True)


def test_small_threaded_batches_leave_no_orphans():
    """A batch that is small against the graph checks only its fresh nodes
    and the nodes its overflow re-prunes dropped, not every link; that must
    still re-attach every orphan."""
    rng = np.random.default_rng(0)
    base, dim = 30000, 16
    x = rng.normal(size=(base + 64 * 40, dim)).astype(np.float32)
    b = NativeHNSWBuilder(dim=dim, space="l2", m=8, ef_construction=60)
    b.add_batch(x[:base], np.arange(base), n_threads=8)
    for s in range(base, len(x), 64):
        b.add_batch(x[s:s + 64], np.arange(s, s + 64), n_threads=8)
    assert b.size == len(x)
    check_integrity(b.export_graph(), require_inbound=True)
