"""North-star-scale cross-validation: the REAL compiled hnswlib engine at
N=1M on the exact res/sweep_1m.json dataset (round-4 verdict item 4 — every
1M+ claim was previously anchored only at 100k).

Builds the actual reference engine (tests/hnswlib_xcheck) over the identical
1M clustered-Gaussian dataset (seed 7, the sweep's generator) with the
identical query stream, records its recall@10 / single-core qps at the
sweep's ef ladder, and re-validates the .bin import path at 1M: the saved
real-engine index round-trips through HNSWIndex.from_hnswlib and serves the
same recall through our native CPU engine.

Everything expensive is cached in /tmp (GT, the ~40-min single-core build
via saveIndex) so restarts resume. CPU-only — safe to run while the
accelerator is held by another process, but qps rows are polluted by
concurrent load; the artifact records the load caveat.

Writes res/hnswlib_parity_1m.json.

Usage: python bin/hnswlib_xcheck_1m.py [N] [out.json]
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

DIM, M, EF_C, K, NQ = 128, 16, 200, 10, 1024
EF_LADDER = (50, 100, 200, 500)


def main():
    import compile as xc

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    out_path = (
        sys.argv[2] if len(sys.argv) > 2 else "res/hnswlib_parity_1m.json"
    )
    eng = xc.build_xcheck_hnswlib()
    if eng is None:
        sys.exit("g++ or /root/reference unavailable")

    # the sweep_1m dataset + query stream, regenerated bit-exactly
    # (bin/sweep1m.py:36-42,91-93: seed 7, 4096 centers, spread 0.5)
    rng = np.random.default_rng(7)
    t0 = time.time()
    centers = rng.normal(size=(4096, DIM)).astype(np.float32)
    x = centers[rng.integers(0, 4096, n)] + 0.5 * rng.normal(
        size=(n, DIM)
    ).astype(np.float32)
    q = x[rng.integers(0, n, NQ)] + 0.05 * rng.normal(
        size=(NQ, DIM)
    ).astype(np.float32)
    print(f"datagen: {time.time()-t0:.0f}s", flush=True)

    # exact numpy GT (single-core BLAS, ~15 min at 1M), cached
    gt_path = f"/tmp/xc1m_gt_n{n}.npz"
    gt = None
    if os.path.exists(gt_path):
        with np.load(gt_path) as z:
            if np.allclose(z["q_head"], q[:4]):
                gt = z["gt"]
                print("gt cache loaded", flush=True)
    if gt is None:
        t0 = time.time()
        x_sq = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
        gt = np.empty((NQ, K), dtype=np.int64)
        for i in range(0, NQ, 64):
            qc = x @ q[i : i + 64].T  # [n, <=64]
            d = x_sq[:, None] - 2.0 * qc
            part = np.argpartition(d, K, axis=0)[:K]  # [K, b]
            row = np.take_along_axis(d, part, axis=0)
            gt[i : i + 64] = np.take_along_axis(
                part, np.argsort(row, axis=0), axis=0
            ).T
            if i % 256 == 0:
                print(f"  gt {i}/{NQ} ({time.time()-t0:.0f}s)", flush=True)
        np.savez(gt_path, gt=gt, q_head=q[:4])
        print(f"gt: {time.time()-t0:.0f}s", flush=True)

    def recall(ids):
        return float(np.mean(
            [len(set(ids[i].tolist()) & set(gt[i].tolist())) / K
             for i in range(NQ)]
        ))

    # --- real hnswlib, single core, cached via its own saveIndex --------
    bin_path = f"/tmp/xc1m_index_n{n}.bin"
    build_s_path = f"/tmp/xc1m_build_s_n{n}.json"  # n-suffixed like the
    # other caches: a smaller-N smoke run must not poison the 1M build time
    q.tofile(f"/tmp/xc1m_q_n{n}.f32")
    build_s = None
    if os.path.exists(build_s_path):
        # a prior (possibly loaded-host) run left the build time behind
        with open(build_s_path) as f:
            build_s = json.load(f)["build_s"]
    if not os.path.exists(bin_path):
        x.tofile(f"/tmp/xc1m_data_n{n}.f32")
        print("real hnswlib build (single-core, ~40 min at 1M)...",
              flush=True)
        r = subprocess.run(
            [eng, "build_search", f"/tmp/xc1m_data_n{n}.f32", str(n),
             str(DIM), str(M), str(EF_C), f"/tmp/xc1m_q_n{n}.f32", str(NQ),
             str(K), "200", f"/tmp/xc1m_ids_n{n}.i64", "",
             bin_path + ".tmp"],
            capture_output=True, text=True, timeout=4 * 3600,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        stats = json.loads(r.stdout.strip().splitlines()[-1])
        build_s = stats["build_s"]
        with open(build_s_path, "w") as f:
            json.dump({"build_s": build_s}, f)
        os.rename(bin_path + ".tmp", bin_path)
        os.remove(f"/tmp/xc1m_data_n{n}.f32")
        print(f"hnswlib build: {build_s:.0f}s", flush=True)

    ladder = []
    for ef in EF_LADDER:
        r = subprocess.run(
            [eng, "load_search", bin_path, str(DIM),
             f"/tmp/xc1m_q_n{n}.f32", str(NQ), str(K), str(ef),
             f"/tmp/xc1m_ids_n{n}.i64"],
            capture_output=True, text=True, timeout=3600,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        stats = json.loads(r.stdout.strip().splitlines()[-1])
        ids = np.fromfile(f"/tmp/xc1m_ids_n{n}.i64", dtype=np.int64).reshape(
            NQ, K
        )
        rec = recall(ids)
        ladder.append({"ef": ef, "recall_at_10": round(rec, 4),
                       "qps": round(stats["qps"], 1)})
        print(f"hnswlib ef={ef:>4} recall@{K}={rec:.4f} "
              f"{stats['qps']:.0f} qps single-core", flush=True)

    # --- 1M .bin import through our engine -------------------------------
    print("importing the 1M .bin via from_hnswlib...", flush=True)
    from hnsw_tpu.models.hnsw import HNSWIndex

    t0 = time.time()
    idx = HNSWIndex.from_hnswlib(bin_path)
    import_s = time.time() - t0
    assert idx.num_elements == n
    t0 = time.time()
    _, our_ids, _ = idx.search_cpu(q, k=K, ef=200)
    our_qps = NQ / (time.time() - t0)
    our_recall = recall(our_ids)
    ref200 = next(r for r in ladder if r["ef"] == 200)
    print(f"our CPU engine on the imported graph: recall@{K}="
          f"{our_recall:.4f} ({our_qps:.0f} qps) vs hnswlib "
          f"{ref200['recall_at_10']:.4f}", flush=True)

    # our device-serving numbers on the same dataset, for the side-by-side
    ours_1m = None
    try:
        with open("res/sweep_1m.json") as f:
            ours_1m = json.load(f)
    except Exception:
        pass

    out = {
        "config": {
            "N": n, "dim": DIM, "M": M, "ef_construction": EF_C, "k": K,
            "nq": NQ, "dataset": "clustered-gaussian-4096c seed7 "
                                 "(identical to res/sweep_1m.json)",
            "engine": "REAL hnswlib compiled from /root/reference "
                      "(AVX-512), single core",
            "load_caveat": "qps rows measured on a 1-core host that may "
                           "run concurrent accelerator processes",
        },
        "hnswlib": {"build_s": build_s, "ladder": ladder},
        "bin_import_1m": {
            "import_s": round(import_s, 1),
            "our_cpu_recall_at_10_ef200": round(our_recall, 4),
            "recall_delta_vs_hnswlib": round(
                our_recall - ref200["recall_at_10"], 4
            ),
            "parity_within_0.005":
                abs(our_recall - ref200["recall_at_10"]) <= 0.005,
        },
        "ours_sweep_1m": None if ours_1m is None else {
            "ef200": next(
                (r for r in ours_1m.get("sweep", [])
                 if r.get("ef") == 200), None
            ),
            "build_s": ours_1m.get("config", {}).get("build_s"),
        },
    }
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["bin_import_1m"]), flush=True)


if __name__ == "__main__":
    main()
