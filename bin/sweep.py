"""Throughput/recall sweep over (batch, expand, ef) on the current backend.

Usage: python bin/sweep.py [N] — measures the batched device traversal at
several operating points and prints a table; used to pick bench.py defaults.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax
    import jax.numpy as jnp

    from hnsw_tpu.core.spaces import L2Space
    from hnsw_tpu.models.bruteforce import BruteforceIndex
    from hnsw_tpu.models.hnsw import HNSWIndex
    from hnsw_tpu.ops.traversal import search_batch

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    dim = 128
    rng = np.random.default_rng(123)
    x = rng.normal(size=(n, dim)).astype(np.float32)

    t0 = time.time()
    idx = HNSWIndex("l2", dim=dim, m=16, ef_construction=200)
    idx.add_items(x)
    print(f"build: {time.time()-t0:.1f}s", flush=True)

    nq = 4096
    q_all = x[rng.integers(0, n, nq)] + 0.05 * rng.normal(size=(nq, dim)).astype(
        np.float32
    )
    oracle = BruteforceIndex(L2Space(dim))
    oracle.add_items(x, np.arange(n))
    t0 = time.time()
    _, gt = oracle.search_knn(q_all, 10)
    print(f"oracle: {time.time()-t0:.1f}s", flush=True)

    dg, vectors, sq, _, labels_np = idx._sync_device()

    def recall(ids, sl):
        got = labels_np[np.minimum(np.asarray(ids), len(labels_np) - 1)]
        return np.mean(
            [len(set(got[i]) & set(gt[sl][i])) / 10 for i in range(len(got))]
        )

    print(f"{'B':>5} {'E':>2} {'ef':>4} {'recall':>7} {'ms/b':>8} {'qps':>9} {'max_hops':>8}")
    for ef in (200,):
        for b in (512, 2048, 4096):
            for e in (1, 2, 4, 8):
                q = jnp.asarray(q_all[:b])

                def run():
                    return search_batch(
                        vectors, dg, q, k=10, ef=ef, space="l2", sq_norms=sq,
                        expand=e, collect_metrics=True,
                    )

                r = run()
                r.dists.block_until_ready()
                t0 = time.time()
                iters = 4
                for _ in range(iters):
                    r = run()
                r.dists.block_until_ready()
                dt = (time.time() - t0) / iters
                rec = recall(r.ids, slice(0, b))
                print(
                    f"{b:>5} {e:>2} {ef:>4} {rec:>7.4f} {dt*1000:>8.1f} "
                    f"{b/dt:>9.0f} {int(np.asarray(r.hops).max()):>8}",
                    flush=True,
                )


if __name__ == "__main__":
    main()
