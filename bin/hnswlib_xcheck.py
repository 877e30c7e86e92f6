"""Record the REAL hnswlib baseline at the bench operating point.

Compiles the actual vendored reference engine (hnswlib/hnswalg.h via
tests/hnswlib_xcheck) and runs it single-core on the bench dataset
(N=100k d=128 M=16 efC=200, clustered, seed 123) with the bench queries
(k=10, ef=200): true hnswlib build time, single-core qps, and recall@10 —
the row every "hnswlib-equivalent" claim is judged against. Then checks:

- recall parity: |native-engine recall - hnswlib recall| <= 0.005;
- .adj interop at N=20k: our exported graph parses byte-exactly through
  the reference's own loader (hnsw_service/hnsw_graph.cpp:14-151).

Writes res/hnswlib_parity.json. CPU-only (no accelerator use). Run it
alone on its host — concurrent processes pollute the qps rows.

Usage: python bin/hnswlib_xcheck.py [out.json]
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(
    0, os.path.join(os.path.dirname(__file__), "..", "tests", "hnswlib_xcheck")
)

N, DIM, M, EF_C, K, EF, NQ = 100_000, 128, 16, 200, 10, 200, 8192


def main():
    import compile as xc

    out_path = sys.argv[1] if len(sys.argv) > 1 else "res/hnswlib_parity.json"
    bin_hnswlib = xc.build_xcheck_hnswlib()
    bin_adj = xc.build_xcheck_adj()
    if bin_hnswlib is None or bin_adj is None:
        sys.exit("g++ or /root/reference unavailable")

    # bench dataset + queries (bench.py's exact stream, seed 123)
    rng = np.random.default_rng(123)
    centers = rng.normal(size=(1024, DIM)).astype(np.float32)
    assign = rng.integers(0, 1024, size=N)
    x = centers[assign] + 0.5 * rng.normal(size=(N, DIM)).astype(np.float32)
    q = x[rng.integers(0, N, NQ)] + 0.05 * rng.normal(
        size=(NQ, DIM)
    ).astype(np.float32)

    gt_cache = f"/tmp/bench_gt_N{N}_d{DIM}_b{NQ}_k{K}_seed123.npz"
    gt = None
    if os.path.exists(gt_cache):
        with np.load(gt_cache) as z:
            if np.allclose(z["q_head"], q[:4]):
                gt = z["gt"]
                print("gt cache loaded", flush=True)
    if gt is None:
        # exact numpy oracle (CPU-only script; chunked to bound memory)
        print("computing numpy ground truth...", flush=True)
        x_sq = (x ** 2).sum(1)
        gt = np.empty((NQ, K), dtype=np.int64)
        for i in range(0, NQ, 512):
            qc = q[i:i + 512]
            d = x_sq[None, :] - 2.0 * (qc @ x.T)
            part = np.argpartition(d, K, axis=1)[:, :K]
            row = np.take_along_axis(d, part, axis=1)
            gt[i:i + 512] = np.take_along_axis(
                part, np.argsort(row, axis=1), axis=1
            )
        np.savez(gt_cache, gt=gt, q_head=q[:4])

    def recall(ids):
        return float(np.mean(
            [len(set(ids[i].tolist()) & set(gt[i].tolist())) / K
             for i in range(NQ)]
        ))

    # --- real hnswlib, single core --------------------------------------
    x.tofile("/tmp/xc100k_data.f32")
    q.tofile("/tmp/xc100k_q.f32")
    print("running real hnswlib (build ~2-4 min single-core)...", flush=True)
    r = subprocess.run(
        [bin_hnswlib, "build_search", "/tmp/xc100k_data.f32", str(N),
         str(DIM), str(M), str(EF_C), "/tmp/xc100k_q.f32", str(NQ), str(K),
         str(EF), "/tmp/xc100k_ids.i64"],
        capture_output=True, text=True, timeout=3600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    stats = json.loads(r.stdout.strip().splitlines()[-1])
    ref_ids = np.fromfile("/tmp/xc100k_ids.i64", dtype=np.int64).reshape(NQ, K)
    ref_recall = recall(ref_ids)
    print(f"hnswlib: {stats['qps']:.0f} qps single-core, "
          f"recall@{K}={ref_recall:.4f}, build {stats['build_s']:.0f}s",
          flush=True)

    # --- our native CPU engine on the bench graph -----------------------
    from hnsw_tpu.models.hnsw import HNSWIndex

    cache = f"/tmp/bench_graph_N{N}_d{DIM}_m{M}_efc{EF_C}_seed123.npz"
    our_build_s = None
    if os.path.exists(cache):
        idx = HNSWIndex.load(cache)
        assert idx.num_elements == N
        print("our graph cache loaded", flush=True)
    else:
        idx = HNSWIndex("l2", dim=DIM, m=M, ef_construction=EF_C)
        t0 = time.time()
        idx.add_items(x)
        our_build_s = time.time() - t0
        idx.save(cache)
    t0 = time.time()
    _, our_ids, _ = idx.search_cpu(q, k=K, ef=EF)
    our_qps = NQ / (time.time() - t0)
    our_recall = recall(our_ids)
    print(f"native engine: {our_qps:.0f} qps single-core, "
          f"recall@{K}={our_recall:.4f}", flush=True)

    # --- .adj interop at 20k through the reference's own loader ---------
    sub = HNSWIndex("l2", dim=DIM, m=M, ef_construction=EF_C)
    sub.add_items(x[:20_000])
    sub._builder.export_adj("/tmp/xc20k.adj")
    g = sub._builder.export_graph()
    with open(os.devnull, "w") as devnull:
        r = subprocess.run(
            [bin_adj, "/tmp/xc20k.adj", "/tmp/xc20k_dump.bin"],
            stdout=devnull, stderr=subprocess.PIPE, text=True, timeout=1800,
        )
    assert r.returncode == 0, r.stderr[-500:]
    raw = np.fromfile("/tmp/xc20k_dump.bin", dtype=np.uint32)
    interop_ok = int(raw[0]) == g.entry_point and int(raw[1]) == g.max_level
    pos, mismatches = 3, 0
    for lvl in range(int(raw[2])):
        cnt = int(raw[pos]); pos += 1
        for _ in range(cnt):
            nid, deg = int(raw[pos]), int(raw[pos + 1]); pos += 2
            nbrs = raw[pos:pos + deg].tolist(); pos += deg
            if g.neighbors(nid, lvl).tolist() != nbrs:
                mismatches += 1
        expect = int((g.node_level >= lvl).sum())
        interop_ok = interop_ok and cnt == expect
    interop_ok = interop_ok and mismatches == 0 and pos == len(raw)
    print(f"adj interop (20k, via reference loader): "
          f"{'OK' if interop_ok else f'FAILED ({mismatches} mismatches)'}",
          flush=True)

    out = {
        "config": {"N": N, "dim": DIM, "M": M, "ef_construction": EF_C,
                   "k": K, "ef": EF, "n_queries": NQ,
                   "dataset": "clustered-gaussian-1024c seed123 (bench)",
                   "hnswlib_simd": "SSE+AVX+AVX512 (-march=native)",
                   "host": "single core"},
        "hnswlib": {"qps_single_core": round(stats["qps"], 1),
                    "build_s": round(stats["build_s"], 1),
                    "recall_at_10": round(ref_recall, 4)},
        "native_engine": {"qps_single_core": round(our_qps, 1),
                          "build_s": round(our_build_s, 1)
                          if our_build_s else "cached",
                          "recall_at_10": round(our_recall, 4)},
        "gates": {
            "recall_parity_within_0.005":
                abs(our_recall - ref_recall) <= 0.005,
            "recall_delta": round(our_recall - ref_recall, 4),
            "adj_interop_via_reference_loader": bool(interop_ok),
        },
    }
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["gates"]), flush=True)


if __name__ == "__main__":
    main()
