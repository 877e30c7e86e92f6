"""Measure the query-service engine's sustained throughput: synchronous
search() vs the 1-deep launch/resolve pipeline the micro-batcher now runs.

This drives the engine exactly as _MicroBatcher._run does (search_launch
batch N, then search_resolve batch N-1), isolating what the pipeline buys on
the accelerator: an unpipelined call pays dispatch + readback serially per
batch. An HTTP-level load test would also measure JSON parsing.

Writes res/service_pipeline.json. Run alone on the accelerator (one process
per card).

Usage: python bin/service_pipeline_bench.py [N] [out.json]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

N, DIM, M, EF_C = 100_000, 128, 16, 200
BATCH, ITERS = 8192, 12


def main():
    import jax

    from hnsw_tpu.models.hnsw import HNSWIndex
    from hnsw_tpu.service.query_service import build_engine

    n = int(sys.argv[1]) if len(sys.argv) > 1 else N
    out_path = sys.argv[2] if len(sys.argv) > 2 else "res/service_pipeline.json"

    cache = f"/tmp/bench_graph_N{n}_d{DIM}_m{M}_efc{EF_C}_seed123.npz"
    rng = np.random.default_rng(123)
    centers = rng.normal(size=(1024, DIM)).astype(np.float32)
    assign = rng.integers(0, 1024, size=n)
    x = centers[assign] + 0.5 * rng.normal(size=(n, DIM)).astype(np.float32)
    if not os.path.exists(cache):
        idx = HNSWIndex("l2", dim=DIM, m=M, ef_construction=EF_C)
        idx.add_items(x)
        idx.save(cache)
        del idx
    q = x[rng.integers(0, n, BATCH)] + 0.05 * rng.normal(
        size=(BATCH, DIM)
    ).astype(np.float32)

    # the bench speed mode (see bench.py): seeded entry, frontier stop,
    # lockstep budget, ef pinned to 160
    engine = build_engine(
        cache, False, "", DIM, 160, 10,
        stop_frontier=1.15, max_iters=14, entry_seeds=4, rescore=0,
    )
    engine.warm_modes(batch=BATCH)

    def run_sync():
        t0 = time.time()
        for _ in range(ITERS):
            engine.search(q, 10, 160)
        return BATCH * ITERS / (time.time() - t0)

    def run_pipelined(depth=2):
        t0 = time.time()
        inflight = []
        for _ in range(ITERS):
            inflight.append(engine.search_launch(q, 10, 160))
            if len(inflight) >= depth:
                engine.search_resolve(inflight.pop(0))
        while inflight:
            engine.search_resolve(inflight.pop(0))
        return BATCH * ITERS / (time.time() - t0)

    # warm once, then measure
    engine.search(q, 10, 160)
    sync_qps = run_sync()
    pipe_qps = run_pipelined()
    print(f"engine sync:      {sync_qps:,.0f} qps", flush=True)
    print(f"engine pipelined: {pipe_qps:,.0f} qps "
          f"({pipe_qps / sync_qps:.2f}x)", flush=True)

    out = {
        "config": {"N": n, "dim": DIM, "batch": BATCH, "iters": ITERS,
                   "mode": "seeds4 + f1.15 + budget14 + ef160",
                   "device": {"platform": jax.devices()[0].platform,
                              "kind": jax.devices()[0].device_kind,
                              "count": len(jax.devices())}},
        "engine_sync_qps": round(sync_qps, 1),
        "engine_pipelined_qps": round(pipe_qps, 1),
        "pipeline_speedup": round(pipe_qps / sync_qps, 3),
    }
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
