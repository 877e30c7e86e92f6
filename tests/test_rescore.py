"""Exact-rescore pass: the top candidates of a search are re-ranked against
the vector table at full f32 precision ("highest"), so the returned
distances are exact whatever precision the hop's products ran at."""

import numpy as np
import pytest

from hnsw_tpu.core.spaces import L2Space
from hnsw_tpu.models.bruteforce import BruteforceIndex
from hnsw_tpu.models.hnsw import HNSWIndex, SearchParams

DIM = 32
N = 2000


@pytest.mark.slow
def test_rescore_recovers_exact_distances(rng):
    x = (rng.normal(size=(N, DIM)) * 3).astype(np.float32)
    idx = HNSWIndex("l2", dim=DIM, m=8, ef_construction=100)
    idx.add_items(x)
    q = rng.normal(size=(16, DIM)).astype(np.float32) * 3

    bf = BruteforceIndex(L2Space(DIM))
    bf.add_items(x, np.arange(N))
    d_ref, l_ref = bf.search_knn(q, 10)

    d_raw, l_raw = idx.search(q, k=10, ef=200, params=SearchParams(
        k=10, ef=200, rescore=0))
    # with rescore: exact f32 distances
    d_rs, l_rs = idx.search(q, k=10, ef=200, params=SearchParams(
        k=10, ef=200, rescore=40))

    def recall(l):
        return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(l, l_ref)])

    r_raw, r_rs = recall(l_raw), recall(l_rs)
    assert r_rs >= r_raw - 1e-9
    # rescored distances match the oracle's exactly for the common labels
    for i in range(16):
        ref = dict(zip(l_ref[i], d_ref[i]))
        for lab, dv in zip(l_rs[i], d_rs[i]):
            if lab in ref:
                np.testing.assert_allclose(dv, ref[lab], rtol=1e-5)


def test_rescore_respects_filters(rng):
    x = rng.normal(size=(N, DIM)).astype(np.float32)
    idx = HNSWIndex("l2", dim=DIM, m=8, ef_construction=100)
    idx.add_items(x)
    q = rng.normal(size=(16, DIM)).astype(np.float32)
    mask = rng.random(N) < 0.5
    d, l = idx.search(q, k=10, ef=200, filter_labels=mask,
                      params=SearchParams(k=10, ef=200, rescore=40))
    ok = l.reshape(-1) >= 0
    assert mask[l.reshape(-1)[ok]].all()


def _dot_precisions(jaxpr):
    """precision params of every dot_general in a jaxpr, sub-jaxprs
    included."""
    from jax.extend.core import ClosedJaxpr, Jaxpr

    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            subs = v if isinstance(v, (tuple, list)) else (v,)
            for sub in subs:
                if isinstance(sub, ClosedJaxpr):
                    out += _dot_precisions(sub.jaxpr)
                elif isinstance(sub, Jaxpr):
                    out += _dot_precisions(sub)
    return out


@pytest.mark.parametrize("space", ["l2", "ip"])
def test_rescore_runs_at_highest_precision(space):
    """The hop may run f32 products at reduced precision (TF32 on the GPU);
    the rescore is what restores exact distances, so its gather-contraction
    must ask for "highest" — pinned on the traced program."""
    import jax
    import jax.numpy as jnp

    from hnsw_tpu.models.hnsw import _rescore_topk

    q = jnp.zeros((4, 8), jnp.float32)
    x = jnp.zeros((16, 8), jnp.float32)
    ids = jnp.zeros((4, 6), jnp.int32)
    d = jnp.zeros((4, 6), jnp.float32)
    jaxpr = jax.make_jaxpr(
        lambda *a: _rescore_topk(*a, k=2, m=4, space=space)
    )(q, x, ids, d)
    precs = _dot_precisions(jaxpr.jaxpr)
    assert precs, "rescore traced no dot_general"
    highest = jax.lax.Precision.HIGHEST
    assert all(p == (highest, highest) for p in precs), precs
