"""Service layer: storage + query services over HTTP (reference parity:
storage_service/main.cpp endpoints, hnsw_service/main.cpp /search,/info,/mem
in both normal and optimized modes)."""

import json
import struct
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from hnsw_tpu.models.hnsw import HNSWIndex

N, DIM = 400, 16


def _post(url, body, ctype="application/json"):
    req = urllib.request.Request(url, data=body, method="POST")
    req.add_header("Content-Type", ctype)
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, r.read()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read()


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """Build an index, start storage + both query services on local ports."""
    tmp = tmp_path_factory.mktemp("svc")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, DIM)).astype(np.float32)

    idx = HNSWIndex("l2", dim=DIM, m=8, ef_construction=100)
    idx.add_items(x)
    ckpt = str(tmp / "index.npz")
    idx.save(ckpt)
    idx.export_adj(ckpt + ".adj")

    from hnsw_tpu.native.vecstore import VectorStore
    from hnsw_tpu.service import query_service, storage_service

    dbpath = str(tmp / "store.log")
    store = VectorStore(dbpath)
    store.put_batch(np.arange(N), x)
    store.close()

    # storage service
    storage_service.StorageHandler.store = VectorStore(dbpath)
    s_httpd = ThreadingHTTPServer(("127.0.0.1", 0), storage_service.StorageHandler)
    s_port = s_httpd.server_address[1]
    threading.Thread(target=s_httpd.serve_forever, daemon=True).start()
    storage = f"http://127.0.0.1:{s_port}"

    # normal-mode query service
    eng_n = query_service.build_engine(ckpt, False, storage, DIM, 64, 10)
    q_httpd = ThreadingHTTPServer(("127.0.0.1", 0), query_service.QueryHandler)

    class NormalHandler(query_service.QueryHandler):
        pass

    NormalHandler.engine = eng_n
    NormalHandler.batcher = query_service._MicroBatcher(eng_n)
    q_httpd.RequestHandlerClass = NormalHandler
    q_port = q_httpd.server_address[1]
    threading.Thread(target=q_httpd.serve_forever, daemon=True).start()

    # optimized-mode query service (vectors pulled from storage service)
    eng_o = query_service.build_engine(ckpt + ".adj", True, storage, DIM, 64, 10)

    class OptHandler(query_service.QueryHandler):
        pass

    OptHandler.engine = eng_o
    OptHandler.batcher = query_service._MicroBatcher(eng_o)
    o_httpd = ThreadingHTTPServer(("127.0.0.1", 0), OptHandler)
    o_port = o_httpd.server_address[1]
    threading.Thread(target=o_httpd.serve_forever, daemon=True).start()

    yield {
        "x": x,
        "storage": storage,
        "normal": f"http://127.0.0.1:{q_port}",
        "opt": f"http://127.0.0.1:{o_port}",
    }
    s_httpd.shutdown()
    q_httpd.shutdown()
    o_httpd.shutdown()


def test_storage_put_get(stack):
    base = stack["storage"]
    vec = np.arange(DIM, dtype=np.float32)
    body = struct.pack("<II", 9999, DIM) + vec.tobytes()
    code, resp = _post(f"{base}/vec/put", body, "application/octet-stream")
    assert code == 200 and resp == b"OK"
    code, resp = _get(f"{base}/vec/get?id=9999")
    j = json.loads(resp)
    assert j["id"] == 9999
    np.testing.assert_allclose(j["values"], vec)


def test_storage_get_missing_404(stack):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(f"{stack['storage']}/vec/get?id=123456")
    assert e.value.code == 404


def test_storage_batch_get(stack):
    code, resp = _post(
        f"{stack['storage']}/vec/batch_get", json.dumps([0, 1, 777777]).encode()
    )
    out = json.loads(resp)
    assert len(out) == 3
    np.testing.assert_allclose(out[0], stack["x"][0], rtol=1e-6)
    assert out[2] is None


def test_storage_put_malformed_400(stack):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{stack['storage']}/vec/put", b"\x01\x02", "application/octet-stream")
    assert e.value.code == 400


def _search(base, query, k=5, ef=64, **extra):
    body = {"query": list(map(float, query)), "k": k, "ef": ef, **extra}
    code, resp = _post(f"{base}/search", json.dumps(body).encode())
    assert code == 200
    return json.loads(resp)


def test_search_normal(stack):
    j = _search(stack["normal"], stack["x"][7])
    assert j["results"][0]["id"] == 7
    assert j["results"][0]["distance"] < 1e-3
    assert j["rss_kb"] > 0
    assert len(j["results"]) == 5


def test_search_optimized(stack):
    j = _search(stack["opt"], stack["x"][7])
    assert j["mode"] == "optimized"
    assert j["results"][0]["id"] == 7


def test_search_modes_agree(stack):
    qn = _search(stack["normal"], stack["x"][21], k=10, ef=64)
    qo = _search(stack["opt"], stack["x"][21], k=10, ef=64)
    ids_n = {r["id"] for r in qn["results"]}
    ids_o = {r["id"] for r in qo["results"]}
    assert len(ids_n & ids_o) >= 9  # same graph, same vectors


def test_search_bad_dim_400(stack):
    body = {"query": [1.0, 2.0], "k": 5}
    req = urllib.request.Request(
        f"{stack['normal']}/search", data=json.dumps(body).encode(), method="POST"
    )
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400


def test_search_batch(stack):
    body = {"queries": [list(map(float, stack["x"][3])), list(map(float, stack["x"][4]))]}
    code, resp = _post(f"{stack['normal']}/search_batch", json.dumps(body).encode())
    j = json.loads(resp)
    assert j["results"][0][0]["id"] == 3
    assert j["results"][1][0]["id"] == 4


def test_info_and_mem(stack):
    for base, mode in ((stack["normal"], "normal"), (stack["opt"], "optimized")):
        _, resp = _get(f"{base}/info")
        j = json.loads(resp)
        assert j["nodes"] == N and j["dim"] == DIM and j["mode"] == mode
        _, resp = _get(f"{base}/mem")
        assert json.loads(resp)["rss_kb"] > 0


def test_concurrent_searches_batched(stack):
    """Micro-batcher: concurrent clients all get correct answers."""
    results = {}

    def worker(i):
        j = _search(stack["normal"], stack["x"][i], k=1, ef=64)
        results[i] = j["results"][0]["id"]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    hits = sum(results[i] == i for i in range(16))
    assert hits >= 15, results


def test_microbatcher_pipelines_and_drains():
    """The batcher must (a) LAUNCH batch N before RESOLVING batch N-1
    (1-deep pipeline: device executes N while N-1 reads back) and (b)
    resolve the final inflight batch without waiting for a successor
    request (idle drain — a regression here hangs the last waiters)."""
    from hnsw_tpu.service.query_service import _MicroBatcher

    events = []

    class FakeEngine:
        class dg:
            entry_point = 0

        def search_launch(self, q, k, ef, ent, mode=None, filters=None):
            events.append(("launch", len(q)))
            return (q, k)

        def search_resolve(self, handle):
            q, k = handle
            events.append(("resolve", len(q)))
            d = np.zeros((len(q), k), np.float32)
            l = np.arange(len(q) * k, dtype=np.int64).reshape(len(q), k)
            return d, l

    b = _MicroBatcher(FakeEngine(), window_ms=20.0, max_batch=8)
    q = np.zeros(4, np.float32)

    # wave 1 then idle: must drain without a wave 2
    d, l = b.submit(q, 1, 8, None)
    assert l.shape == (1,)
    assert events == [("launch", 1), ("resolve", 1)], events

    # two back-to-back waves: wave 2's launch precedes wave 1's... the
    # pipeline interleaving is (launch1, launch2, resolve1, resolve2) when
    # wave 2 arrives within wave 1's execution; with a fake instant engine
    # we can only assert every submit resolves and order stays FIFO
    events.clear()
    outs = {}

    def worker(i):
        outs[i] = b.submit(q, 1, 8, None)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert len(outs) == 6
    launches = [e for e in events if e[0] == "launch"]
    resolves = [e for e in events if e[0] == "resolve"]
    assert sum(n for _, n in launches) == 6
    assert sum(n for _, n in resolves) == 6


def test_normal_mode_excludes_deleted(tmp_path):
    """markDelete semantics through the service (hnswalg.h:853-900): a
    checkpoint with delete-marked elements must never return them from
    /search-equivalent engine calls."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(200, DIM)).astype(np.float32)
    idx = HNSWIndex("l2", dim=DIM, m=8, ef_construction=100)
    idx.add_items(x)
    # self-query before delete: label 5 is its own nearest neighbor
    d0, l0 = idx.search(x[5:6], k=1, ef=64)
    assert l0[0, 0] == 5
    idx.mark_deleted(5)
    ckpt = str(tmp_path / "del.npz")
    idx.save(ckpt)

    from hnsw_tpu.service import query_service

    eng = query_service.build_engine(ckpt, False, "", DIM, 64, 10)
    assert eng.eligible is not None
    d, l = eng.search(x[5:6], k=10, ef=64)
    assert 5 not in set(int(v) for v in l[0])


@pytest.mark.slow
def test_engine_speed_mode_and_rescore(tmp_path):
    """Service speed knobs (adaptive termination + exact rescore): an
    engine built with --stop_frontier/--rescore equivalents must return
    near-identical top-k to the plain engine (the stop is a quality-neutral
    cut at mild settings; rescore re-ranks with exact distances)."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(N, DIM)).astype(np.float32)
    idx = HNSWIndex("l2", dim=DIM, m=8, ef_construction=100)
    idx.add_items(x)
    ckpt = str(tmp_path / "speed.npz")
    idx.save(ckpt)

    from hnsw_tpu.service import query_service

    plain = query_service.build_engine(ckpt, False, "", DIM, 64, 10)
    fast = query_service.build_engine(
        ckpt, False, "", DIM, 64, 10,
        stop_frontier=1.5, stop_patience=48, rescore=20,
    )
    q = x[:32]
    _, l_plain = plain.search(q, k=10, ef=64)
    _, l_fast = fast.search(q, k=10, ef=64)
    overlap = np.mean(
        [len(set(l_plain[i]) & set(l_fast[i])) / 10 for i in range(32)]
    )
    assert overlap >= 0.95, overlap
    # self-queries still find themselves through the fast path
    assert (l_fast[:, 0] == np.arange(32)).mean() >= 0.95


def test_engine_auto_speed_calibration(tmp_path):
    """--auto_speed P: the engine probes the frontier-stopped hop
    distribution at startup and sets the lockstep hop budget itself —
    no hand tuning. It must pick a live cap and keep result quality."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(N, DIM)).astype(np.float32)
    idx = HNSWIndex("l2", dim=DIM, m=8, ef_construction=100)
    idx.add_items(x)
    ckpt = str(tmp_path / "auto.npz")
    idx.save(ckpt)

    from hnsw_tpu.service import query_service

    plain = query_service.build_engine(ckpt, False, "", DIM, 64, 10)
    auto = query_service.build_engine(
        ckpt, False, "", DIM, 64, 10, auto_speed=99.0
    )
    assert auto.stop_frontier == 1.15  # default frontier applied
    assert 0 < auto.max_iters < 2 * 64 + 16  # binding budget chosen
    # an explicit --max_iters wins over calibration
    pinned = query_service.build_engine(
        ckpt, False, "", DIM, 64, 10, auto_speed=99.0, max_iters=7
    )
    assert pinned.max_iters == 7

    q = x[:32]
    _, l_plain = plain.search(q, k=10, ef=64)
    _, l_auto = auto.search(q, k=10, ef=64)
    overlap = np.mean(
        [len(set(l_plain[i]) & set(l_auto[i])) / 10 for i in range(32)]
    )
    assert overlap >= 0.9, overlap
    assert (l_auto[:, 0] == np.arange(32)).mean() >= 0.95


def test_engine_entry_seeds(tmp_path):
    """--entry_seeds S: landmark-seeded entry (one matmul over the
    upper-level nodes replaces the greedy descent) must keep result
    quality, compose with auto_speed calibration, and honor an explicit
    per-request entry override (which bypasses seeding)."""
    rng = np.random.default_rng(13)
    x = rng.normal(size=(N, DIM)).astype(np.float32)
    idx = HNSWIndex("l2", dim=DIM, m=8, ef_construction=100)
    idx.add_items(x)
    ckpt = str(tmp_path / "seeds.npz")
    idx.save(ckpt)

    from hnsw_tpu.service import query_service

    plain = query_service.build_engine(ckpt, False, "", DIM, 64, 10)
    seeded = query_service.build_engine(
        ckpt, False, "", DIM, 64, 10, entry_seeds=4, auto_speed=99.9,
    )
    assert seeded._landmarks(0) is not None
    q = x[:32]
    _, l_plain = plain.search(q, k=10, ef=64)
    _, l_seed = seeded.search(q, k=10, ef=64)
    overlap = np.mean(
        [len(set(l_plain[i]) & set(l_seed[i])) / 10 for i in range(32)]
    )
    assert overlap >= 0.9, overlap
    assert (l_seed[:, 0] == np.arange(32)).mean() >= 0.95
    # per-request entry override still works (seeding is skipped for it)
    _, l_ent = seeded.search(q, k=10, ef=64, entry_ids=np.zeros(32, np.int32))
    assert (l_ent[:, 0] == np.arange(32)).mean() >= 0.9


@pytest.mark.slow
def test_engine_mode_menu(tmp_path):
    """Per-request speed/quality routing (the static-under-jit knobs become
    a precompiled MENU): one engine serves a crippled 'fast' mode and the
    exhaustive 'quality' mode, selected per request, with measurably
    different quality — the analog of the reference's per-request ef/k
    overrides (hnsw_service/main.cpp:63-64,118-120)."""
    rng = np.random.default_rng(17)
    x = rng.normal(size=(N, DIM)).astype(np.float32)
    idx = HNSWIndex("l2", dim=DIM, m=8, ef_construction=100)
    idx.add_items(x)
    ckpt = str(tmp_path / "menu.npz")
    idx.save(ckpt)

    from hnsw_tpu.service import query_service

    eng = query_service.build_engine(
        ckpt, False, "", DIM, 64, 10,
        modes={"fast": {"stop_frontier": 1.05, "max_iters": 2},
               "quality": {},
               "narrow": {"ef": 16}},
    )
    eng.warm_modes()
    q = x[:32] + 0.05 * rng.normal(size=(32, DIM)).astype(np.float32)
    d = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    gt = np.argsort(d, axis=1)[:, :10]

    def recall(l):
        return np.mean([len(set(l[i]) & set(gt[i])) / 10 for i in range(32)])

    _, l_fast = eng.search(q, k=10, ef=64, mode="fast")
    _, l_qual = eng.search(q, k=10, ef=64, mode="quality")
    _, l_def = eng.search(q, k=10, ef=64)  # default == quality here
    r_fast, r_qual, r_def = recall(l_fast), recall(l_qual), recall(l_def)
    assert r_qual > r_fast, (r_qual, r_fast)  # 2 hops can't match exhaustive
    assert r_qual >= 0.9
    assert r_def == r_qual
    # a mode may PIN its serve beam width (the headline speed mode is
    # seeds + ef=160): request ef is overridden, results match a direct
    # ef=16 search exactly
    d_nar, l_nar = eng.search(q, k=10, ef=64, mode="narrow")
    d_16, l_16 = eng.search(q, k=10, ef=16)
    np.testing.assert_array_equal(l_nar, l_16)
    np.testing.assert_array_equal(d_nar, d_16)
    # unknown mode -> loud error, not silent default
    with pytest.raises(KeyError):
        eng.search(q, k=10, ef=64, mode="nope")
    # mode configs with unknown knob names are rejected at build time
    with pytest.raises(ValueError):
        query_service.build_engine(
            ckpt, False, "", DIM, 64, 10, modes={"bad": {"frontier": 1.0}}
        )


def test_http_mode_routing(tmp_path):
    """HTTP layer: 'mode' routes through the micro-batcher, distinct modes
    don't coalesce into one device call, /info advertises the menu, and an
    unknown mode is a 400 with the menu listed."""
    rng = np.random.default_rng(19)
    x = rng.normal(size=(N, DIM)).astype(np.float32)
    idx = HNSWIndex("l2", dim=DIM, m=8, ef_construction=100)
    idx.add_items(x)
    ckpt = str(tmp_path / "route.npz")
    idx.save(ckpt)

    from hnsw_tpu.service import query_service

    eng = query_service.build_engine(
        ckpt, False, "", DIM, 64, 10,
        modes={"fast": {"stop_frontier": 1.05, "max_iters": 2},
               "quality": {}},
    )
    eng.warm_modes()

    class MenuHandler(query_service.QueryHandler):
        pass

    MenuHandler.engine = eng
    MenuHandler.batcher = query_service._MicroBatcher(eng)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), MenuHandler)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{port}"
    try:
        code, body = _get(f"{base}/info")
        info = json.loads(body)
        assert set(info["modes"]) == {"default", "fast", "quality"}

        q = x[5].tolist()
        code_f, body_f = _post(
            f"{base}/search",
            json.dumps({"query": q, "k": 10, "ef": 64, "mode": "fast"}).encode(),
        )
        code_q, body_q = _post(
            f"{base}/search",
            json.dumps({"query": q, "k": 10, "ef": 64, "mode": "quality"}).encode(),
        )
        assert code_f == 200 and code_q == 200
        # self-query: quality finds itself first; both return valid results
        assert json.loads(body_q)["results"][0]["id"] == 5
        assert len(json.loads(body_f)["results"]) > 0

        try:
            _post(
                f"{base}/search",
                json.dumps({"query": q, "k": 10, "mode": "warp"}).encode(),
            )
            assert False, "unknown mode must 400"
        except urllib.error.HTTPError as e:
            assert e.code == 400
            assert "modes" in json.loads(e.read())
    finally:
        httpd.shutdown()


def test_engine_space_preprocessing(tmp_path):
    """The engine resolves the checkpoint's persist space: cosine queries
    are normalized and l2u8 queries shifted at the service boundary (the
    stored vectors are already preprocessed at build time). Round-3 code
    passed the persist name straight to the kernels — a cosine or l2u8
    checkpoint either crashed dispatch or served wrong distances."""
    from hnsw_tpu.service import query_service

    rng = np.random.default_rng(13)
    # cosine: un-normalized queries must match the index's own search
    x = rng.normal(size=(N, DIM)).astype(np.float32) * 3
    idx = HNSWIndex("cosine", dim=DIM, m=8, ef_construction=100)
    idx.add_items(x)
    ckpt = str(tmp_path / "cos.npz")
    idx.save(ckpt)
    eng = query_service.build_engine(ckpt, False, "", DIM, 64, 10)
    assert eng.persist_space == "cosine" and eng.space == "ip"
    q = x[:16] * 7.0  # scale must not matter under cosine
    d_ref, l_ref = idx.search(q, k=10, ef=64)
    _, l_srv = eng.search(q, k=10, ef=64)
    overlap = np.mean(
        [len(set(l_srv[i]) & set(l_ref[i])) / 10 for i in range(16)]
    )
    assert overlap >= 0.95, overlap

    # l2u8: service distances are the exact integer L2 distances
    xu = rng.integers(0, 256, size=(N, DIM)).astype(np.uint8)
    idx8 = HNSWIndex("l2u8", dim=DIM, m=8, ef_construction=100)
    idx8.add_items(xu)
    ckpt8 = str(tmp_path / "u8.npz")
    idx8.save(ckpt8)
    eng8 = query_service.build_engine(ckpt8, False, "", DIM, 64, 10)
    assert eng8.persist_space == "l2u8" and eng8.space == "l2"
    qu = xu[:16]
    d, l = eng8.search(qu.astype(np.float32), k=10, ef=64)
    qi, xi = qu.astype(np.int64), xu.astype(np.int64)
    for i in range(16):
        for lab, dv in zip(l[i], d[i]):
            if lab >= 0:
                assert float(dv) == float(((qi[i] - xi[lab]) ** 2).sum())


def test_mem_cap_rlimit(tmp_path):
    """--mem_cap_mb RLIMIT_AS self-cap (reference hnsw_service/main.cpp:19-22
    parity, already present in the native frontend query_main.cpp:406-410):
    the cap is really installed and an allocation past it fails instead of
    silently paging — run in a subprocess because RLIMIT_AS cannot be raised
    back afterwards."""
    import subprocess
    import sys

    code = (
        "from hnsw_tpu.utils.rss import apply_mem_cap\n"
        "import resource\n"
        "assert apply_mem_cap(0) is False\n"
        "assert apply_mem_cap(512) is True\n"
        "soft, hard = resource.getrlimit(resource.RLIMIT_AS)\n"
        "assert soft == 512 << 20, soft\n"
        "try:\n"
        "    blob = bytearray(1 << 30)\n"
        "    print('ALLOC_OK')\n"
        "except MemoryError:\n"
        "    print('CAPPED')\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd="/root/repo",
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "CAPPED" in r.stdout, r.stdout


def test_search_per_request_filter(stack):
    """Per-request label allowlists (per-query BaseFilterFunctor): each
    request's results obey its own filter, and filtered + unfiltered
    requests coalesce in one micro-batch."""
    x = stack["x"]
    allow = list(range(100, 200))
    j = _search(stack["normal"], x[7], k=5, ef=128, filter=allow)
    got = [r["id"] for r in j["results"]]
    assert got and all(100 <= g < 200 for g in got)
    # unfiltered request still answers exactly
    j2 = _search(stack["normal"], x[7], k=5, ef=128)
    assert j2["results"][0]["id"] == 7

    # concurrent mixed-filter requests: each row obeys its own mask
    results = {}

    def worker(i):
        lo = 50 * (i % 4)
        j = _search(stack["normal"], x[i], k=3, ef=128,
                    filter=list(range(lo, lo + 50)))
        results[i] = (lo, [r["id"] for r in j["results"]])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, (lo, ids) in results.items():
        assert ids and all(lo <= g < lo + 50 for g in ids), (i, lo, ids)


def test_search_batch_per_row_filters(stack):
    """/search_batch accepts per-row 'filters' (null = unfiltered row)."""
    x = stack["x"]
    body = {
        "queries": [list(map(float, x[3])), list(map(float, x[4]))],
        "k": 3, "ef": 128,
        "filters": [list(range(0, 50)), None],
    }
    code, resp = _post(f"{stack['normal']}/search_batch",
                       json.dumps(body).encode())
    j = json.loads(resp)
    row0 = [r["id"] for r in j["results"][0]]
    assert row0 and all(0 <= g < 50 for g in row0)
    assert j["results"][1][0]["id"] == 4  # unfiltered row exact
