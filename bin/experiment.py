"""Experiment harness — parity with the reference bin/experiment.py.

Per size N (reference run_experiment, bin/experiment.py:114-350):
  1. clean the data dir (25-32)
  2. build: index + vector store via the builder CLI (128-129)
  3. spawn storage_service and hnsw query service (135-148) — baseline
     (in-memory) or optimized (storage/compute-separated) mode
  4. recall phase (160-234): fetch all vectors back from the live storage
     service, NumPy brute-force ground truth with argpartition top-k
     (34-57), sampled self-queries against POST /search, set-intersection
     recall (59-66)
  5. memory phase (237-290): n_search random queries while polling /mem RSS
  6. write res/results_{mode}.json + plots (312-348)

Then calculate_memory_reduction (353-464): baseline-vs-optimized memory
reduction % and recall delta, written to res/comparison_results.json.

Usage:
  python bin/experiment.py --sizes 1000 5000 --dim 64 --recall --opt
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import struct
import subprocess
import sys
import time
import urllib.request

import numpy as np

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

RES_DIR = os.path.join(REPO, "res")
DATA_DIR = os.path.join(REPO, "exp_data")


def http_json(url, body=None, timeout=60):
    if body is None:
        req = urllib.request.Request(url)
    else:
        req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST")
        req.add_header("Content-Type", "application/json")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def wait_ready(url, proc, timeout=600):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if proc.poll() is not None:
            raise RuntimeError(f"service died (rc={proc.returncode}) waiting for {url}")
        try:
            http_json(url, timeout=5)
            return
        except Exception:
            time.sleep(0.5)
    raise TimeoutError(url)


def clean_data():
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    os.makedirs(DATA_DIR, exist_ok=True)
    os.makedirs(RES_DIR, exist_ok=True)


def fetch_all_vectors_numpy(storage, dim):
    """Bulk-fetch every vector back from the live storage service
    (reference fetches them one GET at a time, bin/experiment.py:68-111)."""
    with urllib.request.urlopen(f"{storage}/vec/bulk?dim={dim}", timeout=300) as r:
        raw = r.read()
    count, d = struct.unpack_from("<II", raw)
    rec = np.frombuffer(
        raw, dtype=[("id", "<u4"), ("vec", "<f4", (d,))], offset=8, count=count
    )
    order = np.argsort(rec["id"])
    return rec["id"][order].astype(np.int64), np.ascontiguousarray(rec["vec"][order])


def get_ground_truth_numpy(data, query, k, exclude=None):
    """Vectorized L2 + argpartition top-k (reference: experiment.py:34-57)."""
    d = ((data - query[None, :]) ** 2).sum(axis=1)
    if exclude is not None:
        d[exclude] = np.inf
    idx = np.argpartition(d, k)[:k]
    return idx[np.argsort(d[idx])]


def calculate_recall(found, truth):
    """Set-intersection recall (reference: experiment.py:59-66)."""
    return len(set(found) & set(truth)) / max(len(truth), 1)


def run_experiment(sizes, dim, optimized, do_recall, do_mem, m, ef_c, n_search,
                   k=20, ef=200, native=False):
    mode = "optimized" if optimized else "baseline"
    results = {"mode": mode, "sizes": [], "recall": {}, "memory": {}}
    py = sys.executable

    for n in sizes:
        print(f"=== N={n} mode={mode}{' (native)' if native else ''} ===", flush=True)
        clean_data()
        db = os.path.join(DATA_DIR, "store.log")
        graph = os.path.join(DATA_DIR, "index.npz")
        subprocess.run(
            [py, "-m", "hnsw_tpu.service.builder_cli", str(n), str(dim), db, graph,
             str(m), str(ef_c)],
            check=True, cwd=REPO,
        )

        if native:
            # compiled C++ frontends (reference parity: both reference
            # services are native executables with a RLIMIT_AS self-cap)
            from hnsw_tpu.native import build_binary

            sp = subprocess.Popen([build_binary("storage_main"), db, "18081"])
            qs_args = [
                build_binary("query_main"), "--graph", graph + ".adj",
                "--storage", "http://127.0.0.1:18081", "--port", "18080",
                "--dim", str(dim), "--ef", str(ef), "--k", str(k),
                "--optimized", "1" if optimized else "0",
            ]
        else:
            sp = subprocess.Popen(
                [py, "-m", "hnsw_tpu.service.storage_service", db, "18081"], cwd=REPO
            )
            qs_args = [
                py, "-m", "hnsw_tpu.service.query_service", "--port", "18080",
                "--storage", "http://127.0.0.1:18081", "--dim", str(dim),
                "--ef", str(ef), "--k", str(k),
            ]
            if optimized:
                qs_args += ["--graph", graph + ".adj", "--optimized", "1"]
            else:
                qs_args += ["--graph", graph]
        try:
            wait_ready("http://127.0.0.1:18081/info", sp)
            qp = subprocess.Popen(qs_args, cwd=REPO)
            try:
                wait_ready("http://127.0.0.1:18080/info", qp)
                storage = "http://127.0.0.1:18081"
                query = "http://127.0.0.1:18080"

                def check_alive():
                    # crash polling during query phases (reference
                    # experiment.py:173-175,244-246,263-267)
                    for name, p in (("storage", sp), ("query", qp)):
                        if p.poll() is not None:
                            raise RuntimeError(
                                f"{name} service died mid-phase "
                                f"(rc={p.returncode})"
                            )

                if do_recall:
                    ids, vecs = fetch_all_vectors_numpy(storage, dim)
                    rng = np.random.default_rng(7)
                    sample = rng.integers(0, n, size=10)
                    recalls = []
                    for qi in sample:
                        check_alive()
                        truth = get_ground_truth_numpy(vecs, vecs[qi], k, exclude=qi)
                        resp = http_json(
                            f"{query}/search",
                            {"query": vecs[qi].tolist(), "k": k, "ef": ef},
                        )
                        found = [r["id"] for r in resp["results"] if r["id"] != qi]
                        recalls.append(calculate_recall(found, truth))
                    results["recall"][n] = float(np.mean(recalls))
                    print(f"  recall@{k}: {results['recall'][n]:.4f}", flush=True)

                if do_mem:
                    rng = np.random.default_rng(8)
                    rss = []
                    for _ in range(n_search):
                        check_alive()
                        qv = rng.normal(size=dim).astype(np.float32)
                        http_json(f"{query}/search", {"query": qv.tolist(), "k": k})
                        rss.append(http_json(f"{query}/mem")["rss_kb"])
                    results["memory"][n] = {
                        "avg_rss_kb": float(np.mean(rss)),
                        "peak_rss_kb": float(np.max(rss)),
                    }
                    print(f"  rss avg={np.mean(rss):.0f}kB peak={np.max(rss):.0f}kB", flush=True)
                results["sizes"].append(n)
            finally:
                qp.terminate()
                qp.wait(timeout=30)
        finally:
            sp.terminate()
            sp.wait(timeout=30)

    tag = "_native" if native else ""
    out = os.path.join(RES_DIR, f"results_{mode}{tag}.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {out}", flush=True)
    _plot(results, mode + tag)
    return results


def _plot(results, mode):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    if results["memory"]:
        ns = sorted(results["memory"])
        plt.figure()
        plt.plot(ns, [results["memory"][n]["avg_rss_kb"] for n in ns], "o-", label="avg RSS")
        plt.plot(ns, [results["memory"][n]["peak_rss_kb"] for n in ns], "s--", label="peak RSS")
        plt.xlabel("N"); plt.ylabel("RSS (kB)"); plt.legend(); plt.title(f"memory ({mode})")
        plt.savefig(os.path.join(RES_DIR, f"memory_{mode}.png"), dpi=100)
        plt.close()
    if results["recall"]:
        ns = sorted(results["recall"])
        plt.figure()
        plt.plot(ns, [results["recall"][n] for n in ns], "o-")
        plt.xlabel("N"); plt.ylabel("recall"); plt.ylim(0, 1.05); plt.title(f"recall ({mode})")
        plt.savefig(os.path.join(RES_DIR, f"recall_{mode}.png"), dpi=100)
        plt.close()


def calculate_memory_reduction(native=False):
    """Baseline-vs-optimized comparison (reference: experiment.py:353-464)."""
    tag = "_native" if native else ""
    try:
        base = json.load(
            open(os.path.join(RES_DIR, f"results_baseline{tag}.json"))
        )
        opt = json.load(
            open(os.path.join(RES_DIR, f"results_optimized{tag}.json"))
        )
    except FileNotFoundError:
        print("need both baseline and optimized results for comparison")
        return None
    comparison = {"memory_reduction_pct": {}, "recall_delta": {}}
    for n in base.get("memory", {}):
        if n in opt.get("memory", {}):
            b = base["memory"][n]["avg_rss_kb"]
            o = opt["memory"][n]["avg_rss_kb"]
            comparison["memory_reduction_pct"][n] = 100.0 * (b - o) / b if b else 0.0
    for n in base.get("recall", {}):
        if n in opt.get("recall", {}):
            comparison["recall_delta"][n] = opt["recall"][n] - base["recall"][n]
    out = os.path.join(
        RES_DIR, "comparison_native.json" if native else "comparison_results.json"
    )
    with open(out, "w") as f:
        json.dump(comparison, f, indent=2)
    print(f"wrote {out}: {comparison}")
    return comparison


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[10000, 50000, 100000])
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--opt", action="store_true", help="also run optimized mode + compare")
    ap.add_argument("--recall", action="store_true")
    ap.add_argument("--no-mem", action="store_true")
    ap.add_argument("--M", type=int, default=16)
    ap.add_argument("--ef_construction", type=int, default=200)
    ap.add_argument("--n_search", type=int, default=20)
    ap.add_argument(
        "--native", action="store_true",
        help="drive the compiled C++ service frontends instead of the "
             "Python/JAX services",
    )
    args = ap.parse_args()

    run_experiment(
        args.sizes, args.dim, False, args.recall, not args.no_mem,
        args.M, args.ef_construction, args.n_search, native=args.native,
    )
    if args.opt:
        run_experiment(
            args.sizes, args.dim, True, args.recall, not args.no_mem,
            args.M, args.ef_construction, args.n_search, native=args.native,
        )
        calculate_memory_reduction(native=args.native)


if __name__ == "__main__":
    main()
