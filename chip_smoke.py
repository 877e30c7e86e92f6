#!/usr/bin/env python3
"""Chip smoke test: drive the search, service, bulk-build and sharded paths
once on an NVIDIA GPU, at real size, through the entry points a user calls.

    python chip_smoke.py             # one card: phases A-E
    python chip_smoke.py --chips 4   # four cards: the sharded phase only

Phases (one card):
  A  device: card name and power limit, jax devices and versions, XLA_FLAGS,
     compile-cache directory.
  B  kernels against a float64 NumPy reference at d in {96, 128, 960}: the
     exact rescore (precision "highest"), the level-0 hop, l2u8 bit-exact.
  C  main path at SIFT1M shape (1M x 128 clustered L2 from a seed): host
     build, exact oracle, HNSWIndex.search in the exhaustive, seeded speed
     and high-recall modes, a filtered search and a search after deletes.
  D  served path: phase C's index in the query service's engine, HTTP from
     a thread of this process, 64 concurrent /search requests.
  E  device-wave bulk build at 100k x 128 against the host-built graph.

Every phase asserts its gates and nothing catches a failure. The last line
of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Without a GPU the script exits non-zero and prints no such line. Everything
runs in this one process: a JAX process reserves most of the card's memory.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import threading
import time
from unittest import mock

import numpy as np

K = 10
DIM = 128
SEED = 123
CARD = "card unknown"  # "<name>, <power limit>", set by phase A


def log(*a):
    print(*a, flush=True)


def num(*a):
    """A line carrying a measured number: it names the card it ran on."""
    print(f"[{CARD}]", *a, flush=True)


def recall(got, gt):
    k = gt.shape[1]
    return float(np.mean(
        [len(set(got[i][:k]) & set(gt[i])) / k for i in range(len(gt))]
    ))


def dataset(n, seed=SEED):
    """`bench.make_dataset`'s clustered generator (SIFT-like structure) and
    `bench.py`'s perturbed-sample query generator."""
    from bench import make_dataset

    rng = np.random.default_rng(seed)
    x = make_dataset(n, DIM, rng)
    return x, rng


def queries(x, rng, nq):
    return x[rng.integers(0, len(x), nq)] + 0.05 * rng.normal(
        size=(nq, DIM)
    ).astype(np.float32)


def oracle_gt(x, q, k=K):
    from hnsw_tpu.core.spaces import L2Space
    from hnsw_tpu.models.bruteforce import BruteforceIndex

    bf = BruteforceIndex(L2Space(DIM))
    bf.add_items(x, np.arange(len(x)))
    _, gt = bf.search_knn(q, k)  # precision "highest": the exact oracle
    return np.asarray(gt)


def timed_search(idx, q, params, reps=3):
    """(dists, labels, best queries/s over `reps` warm calls)."""
    d, lab = idx.search(q, params=params)  # compile + warm
    best = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        d, lab = idx.search(q, params=params)
        best = max(best, len(q) / (time.perf_counter() - t0))
    return d, lab, best


# ---------------------------------------------------------------------------
# A. Device
# ---------------------------------------------------------------------------


def phase_a():
    global CARD
    import jax
    import jaxlib

    from hnsw_tpu.utils.compile_cache import enable_compile_cache

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(smi)
    CARD = smi.splitlines()[0].strip()
    log(f"A devices: {jax.devices()}")
    log(f"A jax {jax.__version__} jaxlib {jaxlib.__version__}")
    log(f"A XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"A compile cache: {enable_compile_cache()}")


# ---------------------------------------------------------------------------
# B. Kernels against the float64 reference
# ---------------------------------------------------------------------------


def _kernel_case(space_name, dim, n, b, rng):
    """A table of n rows whose last row is the zero sentinel, a level-0
    adjacency with sentinel links mixed in, and [b, 2] chosen nodes."""
    from hnsw_tpu.core.spaces import get_space

    sp = get_space(space_name, dim)
    if space_name == "l2u8":
        x = sp.preprocess(rng.integers(0, 256, (n, dim)).astype(np.uint8))
        q = sp.preprocess(rng.integers(0, 256, (b, dim)).astype(np.uint8))
    else:
        x = rng.normal(size=(n, dim)).astype(np.float32)
        q = rng.normal(size=(b, dim)).astype(np.float32)
    x[n - 1] = 0.0
    m0 = 32
    level0 = rng.integers(0, n - 1, (n, m0)).astype(np.int32)
    level0[:, m0 - 6:] = n - 1
    level0[n - 1] = n - 1
    chosen = rng.integers(0, n - 1, (b, 2)).astype(np.int32)
    chosen[::7, 1] = n - 1
    return sp, x, level0, chosen, q


def _ref(sp, x, ids, q):
    """float64 distances and each entry's f32 forward-error scale."""
    rows = x.astype(np.float64)[ids]
    q64 = q.astype(np.float64)[:, None, :]
    dot_abs = np.abs(rows * q64).sum(-1)
    if sp.name == "l2":
        ref = ((rows - q64) ** 2).sum(-1)
        scale = 2 * dot_abs + (rows**2).sum(-1) + (q64**2).sum(-1)
    else:
        ref = 1.0 - (rows * q64).sum(-1)
        scale = dot_abs + 1.0
    return ref, scale


def phase_b(n=100_000, b=1024):
    import functools

    import jax
    import jax.numpy as jnp

    from hnsw_tpu.ops.distance import gather_dist
    from hnsw_tpu.ops.hop import hop_impl, hop_triton, hop_xla

    rng = np.random.default_rng(7)
    for dim in (96, 128, 960):
        for space_name in ("l2", "ip", "l2u8"):
            sp, x, level0, chosen, q = _kernel_case(space_name, dim, n, b, rng)
            xd, qd = jnp.asarray(x), jnp.asarray(q)
            ld, cd = jnp.asarray(level0), jnp.asarray(chosen)
            sq = jnp.sum(xd * xd, axis=-1) if sp.needs_sq_norms else None
            ids = level0[chosen].reshape(b, -1)  # 64 rows per query
            ref, scale = _ref(sp, x, ids, q)
            tag = f"d={dim} {space_name}"
            chosen_impl = hop_impl(qd, xd, ld, cd)
            log(f"B hop implementation chosen for {tag}: {chosen_impl}")
            assert chosen_impl == "triton", (tag, chosen_impl)

            # the exact rescore's gather-contraction
            resc = jax.jit(functools.partial(
                gather_dist, space=sp.name, precision="highest"))
            d = np.asarray(resc(qd, xd, jnp.asarray(ids), x_sq_norms=sq))
            err = np.abs(d - ref)
            if space_name == "l2u8":
                assert np.array_equal(d.astype(np.float64), ref), tag
            else:
                # f32 at "highest": error within f32 rounding of the terms
                assert np.all(err <= 1e-5 * (np.abs(ref) + scale)), (
                    tag, float((err / scale).max()))
            log(f"B rescore {tag}: max |err|/scale "
                f"{float((err / scale).max()):.3e} (rtol 1e-5)")

            for name in ("xla", "triton"):
                if name == "xla":
                    hd, hid = jax.jit(hop_xla, static_argnums=(4,))(
                        qd, xd, ld, cd, sp.name, sq)
                else:
                    hd, hid = hop_triton(qd, xd, ld, cd, sp.name)
                assert np.array_equal(np.asarray(hid), ids), (tag, name)
                hd = np.asarray(hd).astype(np.float64)
                rel = float((np.abs(hd - ref) / scale).max())
                if space_name == "l2u8":
                    assert np.array_equal(hd, ref), (tag, name)
                    prec = "exact integers"
                else:
                    # default precision: TF32 rounds each f32 input to 10
                    # mantissa bits, so a product is off by <= ~2^-10
                    # relative; fp32 products stay ~1e-7
                    assert rel <= 2e-3, (tag, name, rel)
                    prec = "f32" if rel <= 1e-5 else "tf32"
                log(f"B hop[{name}] {tag}: max |err|/scale {rel:.3e} -> "
                    f"runs at {prec} (bound 2e-3 = TF32)")


# ---------------------------------------------------------------------------
# C. Main path at SIFT1M shape
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def pinned_hop(impl):
    """Pin `hop_impl`'s answer to `impl` ("xla" or "triton"). A compiled
    search is keyed by its static arguments, not by this choice, so the
    compile caches are dropped on the way in and out."""
    import jax

    from hnsw_tpu.ops import hop

    jax.clear_caches()
    try:
        with mock.patch.object(hop, "hop_impl", lambda *a, **k: impl):
            yield
    finally:
        jax.clear_caches()


def time_hops(idx, q, params, label, reps=3):
    """Search time of each hop implementation on the same index and
    queries, in turns xla, triton, triton, xla; each turn keeps its best of
    `reps` warm calls of (1) `HNSWIndex.search`, end to end, and (2) its
    device calls alone — landmark seeding and `search_batch` on queries
    already on the card — so (1) - (2) is the host side of `search`."""
    import jax
    import jax.numpy as jnp

    from hnsw_tpu.ops.topk import bruteforce_topk
    from hnsw_tpu.ops.traversal import search_batch

    if jax.default_backend() != "gpu":
        return {}
    dg, x, sq, _, _ = idx._sync_device()
    qd = jnp.asarray(q)

    def device():
        seed_kw = {}
        if params.entry_seeds:
            lv, li, lsq = idx._landmark_arrays(dg, x, sq)
            sd, si = bruteforce_topk(qd, lv, params.entry_seeds, "l2",
                                     x_sq_norms=lsq)
            seed_kw = {"seed_ids": jnp.take(li, si, axis=0),
                       "seed_dists": sd}
        r = search_batch(
            x, dg, qd, k=params.k, ef=params.ef, space="l2", sq_norms=sq,
            expand=params.expand, max_iters=params.max_iters,
            stop_frontier=params.stop_frontier, **seed_kw)
        r.dists.block_until_ready()

    out = {}
    for impl in ("xla", "triton", "triton", "xla"):
        with pinned_hop(impl):
            _, _, qps = timed_search(idx, q, params, reps)
            device()  # compile + warm
            dev = min(_wall(device) for _ in range(reps))
        out.setdefault(impl, []).append((len(q) / qps, dev))
    for impl, ts in out.items():
        turns = "; ".join(f"{e * 1e3:.2f} / {d * 1e3:.2f}" for e, d in ts)
        num(f"hop-timing {label} [{impl}]: ms per batch of {len(q)}, "
            f"search / device calls, one pair per turn: {turns}")
    return out


def _wall(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def phase_c(n=1_000_000, nq=8192, n_cpu=512):
    from hnsw_tpu.models.hnsw import HNSWIndex, SearchParams

    x, rng = dataset(n)
    q = queries(x, rng, nq)
    log(f"C data: N={n} d={DIM} clustered L2, {nq} perturbed queries")
    if n < 1_000_000:
        log(f"C CUT: N={n} instead of 1,000,000")

    t0 = time.perf_counter()
    idx = HNSWIndex("l2", dim=DIM, m=16, ef_construction=200)
    idx.add_items(x)
    num(f"C host build (threaded, {os.cpu_count()} cores): "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    gt = oracle_gt(x, q)
    num(f"C exact oracle ({nq} queries, precision highest, compile "
        f"included): {time.perf_counter() - t0:.2f} s")

    # (a) the exhaustive beam at ef=200
    pa = SearchParams(k=K, ef=200)
    _, la, qps_a = timed_search(idx, q, pa)
    r_a = recall(la, gt)
    num(f"C (a) exhaustive ef=200: recall@10 {r_a:.4f}, {qps_a:.1f} queries/s")
    _, lc, _ = idx.search_cpu(q[:n_cpu], k=K, ef=200)
    r_cpu, r_a512 = recall(lc, gt[:n_cpu]), recall(la[:n_cpu], gt[:n_cpu])
    log(f"C (a) vs search_cpu on {n_cpu} queries: device {r_a512:.4f}, "
        f"cpu {r_cpu:.4f}")
    assert r_a512 >= r_cpu - 0.01, (r_a512, r_cpu)

    # (b) the seeded speed mode, hop budget calibrated on this card
    t0 = time.perf_counter()
    pb = idx.calibrate_speed_mode(k=K, ef=160, expand=2, stop_frontier=1.15,
                                  entry_seeds=4)
    log(f"C (b) calibrated hop budget max_iters={pb.max_iters} "
        f"({time.perf_counter() - t0:.1f} s)")
    _, lb, qps_b = timed_search(idx, q, pb)
    r_b = recall(lb, gt)
    num(f"C (b) speed (seeds 4, ef 160, frontier 1.15, budget "
        f"{pb.max_iters}): recall@10 {r_b:.4f}, {qps_b:.1f} queries/s")
    assert r_b >= 0.95, r_b

    # (c) the high-recall mode: hnswlib's lower-bound cut + full rescore
    pc = SearchParams(k=K, ef=200, expand=2, stop_frontier=1.15,
                      frontier_rank=200, rescore=200, entry_seeds=4)
    _, lcr, qps_c = timed_search(idx, q, pc)
    r_c = recall(lcr, gt)
    num(f"C (c) high-recall (frontier_rank=ef, rescore=ef): recall@10 "
        f"{r_c:.4f}, {qps_c:.1f} queries/s")
    assert r_c >= r_a, (r_c, r_a)

    # filtered search: no excluded label may come back
    keep = np.random.default_rng(1).random(n) < 0.5
    _, lf = idx.search(q[:1024], k=K, ef=200, filter_labels=keep)
    got = lf[lf >= 0]
    assert got.size > 0.9 * lf.size and keep[got].all()
    log(f"C filtered search (50% allowlist): {got.size} results, none "
        "excluded")

    # deletes: the true nearest neighbor of 64 queries, marked deleted
    victims = np.unique(gt[:64, 0])
    for lab in victims:
        idx.mark_deleted(int(lab))
    _, ld = idx.search(q[:64], k=K, ef=200)
    assert not np.isin(ld, victims).any()
    assert (ld >= 0).all()
    log(f"C search after mark_deleted: none of {len(victims)} deleted "
        "labels returned")
    for lab in victims:
        idx.unmark_deleted(int(lab))

    time_hops(idx, q, pa, f"N={n} (a) ef=200")
    time_hops(idx, q, pb, f"N={n} (b) speed")
    return idx, x, q


# ---------------------------------------------------------------------------
# D. Served path
# ---------------------------------------------------------------------------


def phase_d(idx, q, n_req=64, ef=128, platform="gpu"):
    import tempfile
    import urllib.request
    from http.server import ThreadingHTTPServer

    from hnsw_tpu.models.hnsw import SearchParams
    from hnsw_tpu.service import query_service as qs

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "index.npz")
        idx.save(path, compress=False)
        t0 = time.perf_counter()
        engine = qs.build_engine(path, False, "", DIM, ef, K)
        num(f"D engine load: {time.perf_counter() - t0:.2f} s")
    qs.QueryHandler.engine = engine
    qs.QueryHandler.batcher = qs._MicroBatcher(engine)

    class Server(ThreadingHTTPServer):
        request_queue_size = 256  # all requests connect at once

    httpd = Server(("127.0.0.1", 0), qs.QueryHandler)
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(f"{base}/info", timeout=60) as r:
            info = json.loads(r.read())
        log(f"D /info: {info}")
        assert info["device"]["platform"] == platform, info
        assert info["nodes"] == idx.num_elements

        qq = q[:n_req]
        out = [None] * n_req

        def one(i):
            body = json.dumps({"query": qq[i].tolist(), "k": K, "ef": ef})
            req = urllib.request.Request(
                f"{base}/search", data=body.encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as r:
                out[i] = json.loads(r.read())["results"]

        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(n_req)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(o is not None for o in out), "a request failed"
        num(f"D {n_req} concurrent /search requests (compile included): "
            f"{time.perf_counter() - t0:.2f} s")
    finally:
        httpd.shutdown()
        httpd.server_close()

    # the engine searches with expand=2; the micro-batcher's k bucket only
    # widens the returned list, so compare at expand=2 and the same ef
    d_ref, l_ref = idx.search(qq, params=SearchParams(k=K, ef=ef, expand=2))
    ties = 0
    for i in range(n_req):
        labs = [r["id"] for r in out[i]]
        dist = np.asarray([r["distance"] for r in out[i]])
        if labs == l_ref[i].tolist():
            continue
        # equal up to distance ties: the distance profiles agree
        assert len(labs) == K, (i, labs)
        np.testing.assert_allclose(dist, d_ref[i], rtol=1e-3, atol=1e-3)
        ties += 1
    log(f"D served labels equal in-process HNSWIndex.search for "
        f"{n_req - ties}/{n_req} queries, the rest up to distance ties")


# ---------------------------------------------------------------------------
# E. Device-wave bulk build
# ---------------------------------------------------------------------------


def phase_e(n=100_000, nq=2048):
    from hnsw_tpu.core.graph import check_integrity
    from hnsw_tpu.models.bulk_build import bulk_build
    from hnsw_tpu.models.hnsw import HNSWIndex, SearchParams

    x, rng = dataset(n, seed=SEED + 1)
    q = queries(x, rng, nq)
    t0 = time.perf_counter()
    bulk = bulk_build(x, m=16, ef_construction=200)
    num(f"E device-wave bulk build N={n}: {time.perf_counter() - t0:.2f} s "
        "(compile included)")
    check_integrity(bulk.graph)
    log("E check_integrity: ok")

    t0 = time.perf_counter()
    host = HNSWIndex("l2", dim=DIM, m=16, ef_construction=200)
    host.add_items(x)
    num(f"E host build N={n}: {time.perf_counter() - t0:.2f} s")
    gt = oracle_gt(x, q)
    p = SearchParams(k=K, ef=200)
    r_bulk = recall(bulk.search(q, params=p)[1], gt)
    r_host = recall(host.search(q, params=p)[1], gt)
    log(f"E recall@10 at ef=200: bulk {r_bulk:.4f}, host {r_host:.4f}")
    assert r_bulk >= r_host - 0.01, (r_bulk, r_host)
    time_hops(host, queries(x, rng, 8192), p, f"N={n} (a) ef=200")
    pb = host.calibrate_speed_mode(k=K, ef=160, expand=2, stop_frontier=1.15,
                                   entry_seeds=4)
    log(f"E calibrated hop budget at N={n}: max_iters={pb.max_iters}")
    time_hops(host, queries(x, rng, 8192), pb, f"N={n} (b) speed")


# ---------------------------------------------------------------------------
# Four cards: the sharded index against one card, on the phase-C data
# ---------------------------------------------------------------------------


def phase_sharded(n=1_000_000, nq=2048, chips=4):
    import jax
    from jax.sharding import Mesh

    from hnsw_tpu.models.hnsw import HNSWIndex, SearchParams
    from hnsw_tpu.parallel.sharding import ShardedHNSWIndex

    devs = jax.devices()
    assert len(devs) == chips, (len(devs), chips)
    x, rng = dataset(n)
    q = queries(x, rng, nq)
    gt = oracle_gt(x, q)

    # all to all links: the mesh follows the algorithm, one flat shard axis
    mesh = Mesh(np.array(devs), ("shard",))
    t0 = time.perf_counter()
    sh = ShardedHNSWIndex("l2", DIM, mesh=mesh, m=16, ef_construction=200)
    sh.build(x)
    num(f"S sharded build ({chips} shards, host threads): "
        f"{time.perf_counter() - t0:.2f} s")
    arrays = sh.arrays
    for name in ("vectors", "level0", "labels"):
        placed = {s.device for s in getattr(arrays, name).addressable_shards}
        assert placed == set(devs), (name, placed)
    log(f"S index arrays spread over {len(devs)} devices: {devs}")

    sh.search(q, k=K, ef=200)  # compile + warm
    t0 = time.perf_counter()
    _, l_sh = sh.search(q, k=K, ef=200)
    qps_sh = nq / (time.perf_counter() - t0)

    one = HNSWIndex("l2", dim=DIM, m=16, ef_construction=200)
    one.add_items(x)
    _, l_one, qps_one = timed_search(one, q, SearchParams(k=K, ef=200))
    r_sh, r_one = recall(l_sh, gt), recall(l_one, gt)
    num(f"S recall@10 at ef=200: sharded {r_sh:.4f} ({qps_sh:.1f} "
        f"queries/s), one card {r_one:.4f} ({qps_one:.1f} queries/s)")
    assert r_sh >= r_one - 0.01, (r_sh, r_one)
    owners = {sh._label_map[int(lab)][0] for lab in l_sh.ravel() if lab >= 0}
    assert owners == set(range(chips)), owners
    log(f"S merged labels come from shards {sorted(owners)}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="phase C (and sharded) dataset size")
    args = ap.parse_args()

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    t_start = time.perf_counter()
    phase_a()
    if args.chips == 4:
        phase_sharded(n=args.n, chips=4)
    else:
        phase_b()
        idx, _, q = phase_c(n=args.n)
        phase_d(idx, q)
        del idx
        phase_e()
    num(f"total {time.perf_counter() - t_start:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
