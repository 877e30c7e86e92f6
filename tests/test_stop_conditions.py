"""Adaptive termination + pluggable stop conditions (VERDICT r2 item 2 and
the BaseSearchStopCondition interface, hnswlib/hnswlib.h:134-150)."""

import jax.numpy as jnp
import numpy as np
import pytest

from hnsw_tpu.core.spaces import L2Space
from hnsw_tpu.models.bruteforce import BruteforceIndex
from hnsw_tpu.models.hnsw import HNSWIndex, SearchParams

DIM = 24
N = 4000


def _setup(_unused=None):
    rng = np.random.default_rng(77)
    x = rng.normal(size=(N, DIM)).astype(np.float32)
    idx = HNSWIndex("l2", dim=DIM, m=8, ef_construction=100)
    idx.add_items(x)
    bf = BruteforceIndex(L2Space(DIM))
    bf.add_items(x, np.arange(N))
    q = rng.normal(size=(64, DIM)).astype(np.float32)
    _, gt = bf.search_knn(q, 10)
    return idx, q, gt


def _recall(l, gt):
    return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(l, gt)])


def test_adaptive_stop_cuts_hops_at_tiny_recall_cost(rng):
    idx, q, gt = _setup(rng)
    p_full = SearchParams(k=10, ef=200, collect_metrics=True)
    d0, l0 = idx.search(q, params=p_full)
    hops_full = int(np.sum(idx.last_metrics.hops))
    r_full = _recall(l0, gt)

    p_fast = SearchParams(k=10, ef=200, collect_metrics=True, stop_patience=32)
    d1, l1 = idx.search(q, params=p_fast)
    hops_fast = int(np.sum(idx.last_metrics.hops))
    r_fast = _recall(l1, gt)

    # mechanics on this deliberately hard (unclustered, tiny-N) set: far
    # fewer expansions at a bounded recall cost. The production operating
    # point is calibrated at scale on the accelerator (chip_smoke.py).
    assert hops_fast < 0.6 * hops_full, (hops_fast, hops_full)
    assert r_fast >= r_full - 0.06, (r_fast, r_full)


def test_frontier_stop_cuts_tail_iterations(rng):
    idx, q, gt = _setup(rng)
    p_full = SearchParams(k=10, ef=200, collect_metrics=True)
    d0, l0 = idx.search(q, params=p_full)
    max_full = int(np.max(idx.last_metrics.hops))
    r_full = _recall(l0, gt)

    p_fast = SearchParams(
        k=10, ef=200, collect_metrics=True, stop_frontier=1.3
    )
    d1, l1 = idx.search(q, params=p_fast)
    max_fast = int(np.max(idx.last_metrics.hops))
    r_fast = _recall(l1, gt)
    # the frontier cut must shorten the slowest query (the wall-clock
    # driver for a batched while_loop), not just the mean
    assert max_fast < 0.8 * max_full, (max_fast, max_full)
    assert r_fast >= r_full - 0.05, (r_fast, r_full)


def test_tiny_patience_is_aggressive_but_sane(rng):
    idx, q, gt = _setup(rng)
    d, l = idx.search(
        q, params=SearchParams(k=10, ef=200, stop_patience=8)
    )
    assert _recall(l, gt) >= 0.6  # degraded but functional


def _stop_after_5(view):
    return jnp.broadcast_to(view.it >= 5, view.beam_d.shape[:1])


def test_custom_stop_fn_caps_iterations(rng):
    idx, q, gt = _setup(rng)
    p = SearchParams(k=10, ef=200, collect_metrics=True, stop_fn=_stop_after_5)
    d, l = idx.search(q, params=p)
    # stop fires after the 6th iteration completes (evaluated post-hop),
    # expand=1 -> at most ~7 hops counted
    assert int(np.max(idx.last_metrics.hops)) <= 7
    # results are still valid prefixes of a beam search
    assert np.isfinite(np.asarray(d)).all()


def test_epsilon_style_stop_fn(rng):
    """A radius cut expressed as a pluggable condition: stop once the whole
    top-k lies within eps (EpsilonSearchStopCondition analog,
    hnswlib/stop_condition.h:218-275)."""
    idx, q, gt = _setup(rng)

    def stop_eps(view):
        return view.beam_d[:, 9] <= 30.0

    p = SearchParams(k=10, ef=200, stop_fn=stop_eps, collect_metrics=True)
    d, l = idx.search(q, params=p)
    assert np.isfinite(np.asarray(d)).all()


def test_hop_budget_caps_lockstep_iterations(rng):
    """max_iters is the lockstep hop budget: the batch runs at the slowest
    query's pace, so a hard cap near the hop-count p99 is the headline speed
    mode (bench.py MAX_ITERS)."""
    idx, q, gt = _setup(rng)
    p_full = SearchParams(k=10, ef=200, collect_metrics=True)
    d0, l0 = idx.search(q, params=p_full)
    max_full = int(np.max(idx.last_metrics.hops))
    r_full = _recall(l0, gt)

    cap = max(8, int(max_full * 0.6))
    p_cap = SearchParams(k=10, ef=200, collect_metrics=True, max_iters=cap)
    d1, l1 = idx.search(q, params=p_cap)
    # expand=1 in the default params -> hops ~ iterations
    assert int(np.max(idx.last_metrics.hops)) <= cap + 1
    assert _recall(l1, gt) >= r_full - 0.05


@pytest.mark.slow
def test_calibrate_speed_mode_auto_budget(rng):
    """calibrate_speed_mode packages the headline tuning recipe: probe the
    frontier-stopped hop distribution on self-queries, cap max_iters at its
    p-th percentile + margin. The returned params must (a) carry a live,
    binding budget, (b) serve recall within tolerance of the exhaustive
    beam on an independent query set."""
    idx, q, gt = _setup(rng)
    params = idx.calibrate_speed_mode(
        k=10, ef=200, stop_frontier=1.3, percentile=99, margin=2, sample=256
    )
    assert params is idx.speed_params
    assert params.stop_frontier == 1.3
    assert 0 < params.max_iters < 2 * 200 + 16  # binding, not the default cap

    d0, l0 = idx.search(q, params=SearchParams(k=10, ef=200))
    d1, l1 = idx.search(q, params=params)
    assert _recall(l1, gt) >= _recall(l0, gt) - 0.05
    # the budget really caps the loop
    p_m = SearchParams(
        k=10, ef=200, expand=params.expand, collect_metrics=True,
        stop_frontier=params.stop_frontier, max_iters=params.max_iters,
    )
    idx.search(q, params=p_m)
    assert int(np.max(idx.last_metrics.hops)) <= params.expand * (
        params.max_iters + 1
    )


def test_last_improve_metric_bounds_needed_iterations(rng):
    """last_improve records the last iteration each query's k-th best
    distance improved. Capping max_iters at the batch max of last_improve
    must reproduce the exhaustive top-k exactly — the metric is the
    certificate that later iterations were wasted lockstep time."""
    idx, q, gt = _setup(rng)
    p = SearchParams(k=10, ef=200, collect_metrics=True)
    d0, l0 = idx.search(q, params=p)
    last = np.asarray(idx.last_metrics.last_improve)
    hops = np.asarray(idx.last_metrics.hops)
    assert last.shape == hops.shape
    assert (last >= 1).all() and (last <= hops).all()
    assert last.max() < hops.max()  # there IS a wasted tail to cut

    cap = int(last.max())
    d1, l1 = idx.search(q, params=SearchParams(k=10, ef=200, max_iters=cap))
    assert np.array_equal(l0, l1)
    np.testing.assert_allclose(d0, d1, rtol=1e-6)


def test_frontier_rank_ef_recovers_wide_beam_recall(rng):
    """The k-th-pinned frontier caps recall no matter how wide the beam is;
    frontier_rank=ef (hnswlib's own lower bound — the worst of the ef-sized
    result heap, hnswalg.h:342-436) must recover the exhaustive wide beam's
    recall while still terminating adaptively."""
    idx, q, gt = _setup(rng)
    ef = 400

    d_x, l_x = idx.search(q, params=SearchParams(k=10, ef=ef))
    r_exh = _recall(l_x, gt)

    p_k = SearchParams(k=10, ef=ef, collect_metrics=True, stop_frontier=1.0)
    _, l_k = idx.search(q, params=p_k)
    hops_k = int(np.max(idx.last_metrics.hops))
    r_k = _recall(l_k, gt)

    p_ef = SearchParams(
        k=10, ef=ef, collect_metrics=True, stop_frontier=1.0,
        frontier_rank=ef,
    )
    _, l_ef = idx.search(q, params=p_ef)
    hops_ef = int(np.max(idx.last_metrics.hops))
    r_ef = _recall(l_ef, gt)

    # the ef-referenced cut dominates the k-referenced one on recall and
    # matches the exhaustive beam (it only stops once even the ef-th-best
    # can't be displaced), while the k-pinned cut stops far earlier
    assert r_ef >= r_k, (r_ef, r_k)
    assert r_ef >= r_exh - 0.01, (r_ef, r_exh)
    assert hops_k < hops_ef  # rank=k is the more aggressive cut
