"""Query service: HTTP JSON search API over the device-resident index.

Endpoint parity with the reference hnsw_service (hnsw_service/main.cpp):

  POST /search  {"query": [floats], "k": int, "ef": int, "entry_id": int?}
                -> {"results": [{"id", "distance"}...], "rss_kb", "mode"}
  GET  /info    -> {"nodes", "dim", "ef", "mode", "space", "device", ("storage")}
  GET  /mem     -> {"rss_kb"}            (main.cpp:149-153)

plus /search_batch {"queries": [[...]...], ...} for bulk clients.

Two modes, like the reference (main.cpp:51-147):
- normal: loads a full native checkpoint (vectors + graph) and serves from
  device memory.
- optimized (storage/compute split): loads only the adjacency file
  (reference .adj format) and fetches vectors from the storage service —
  but in ONE bulk transfer at startup straight into device memory, not one
  HTTP GET per visited node per query (the reference's dominant cost,
  hnsw_graph.cpp:174-212). Host RSS stays low: vectors live on device.

Concurrent single-query requests are coalesced by a micro-batcher into one
device call (the reference handles them one pointer-chase at a time).

Speed knobs (flags, reported by /info): `--stop_frontier` /
`--stop_patience` enable the adaptive-termination speed mode, `--max_iters`
caps the lockstep hop budget (batch time = slowest query), `--rescore M`
re-ranks the top M candidates at full f32 precision (default off), and
`--auto_speed P` tunes frontier + budget automatically at startup from a
hop-distribution probe at percentile P (e.g. 99).

These values are static under jit — but that is a MENU, not a wall:
`--modes '{"speed": {"stop_frontier": 1.15, "max_iters": 14,
"entry_seeds": 4, "ef": 160}, "quality": {}}'` registers named
SearchParams variants, each its own compiled program (warmed at
startup), and a request routes with `"mode": "speed"` — per-request
quality-vs-speed in one process, the analog of the reference's
per-request ef/k overrides (hnsw_service/main.cpp:63-64,118-120). A
mode's "ef" pins its serve beam width (the headline speed mode narrows
to ef=160 under seeded entry); without it the request's ef applies.
The flat flags define the "default" mode.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from hnsw_tpu.utils.rss import current_rss_kb


class _Engine:
    """Device-resident search state shared by both modes."""

    #: knobs a named mode may override (everything jit-static per variant).
    #: "ef" pins the mode's serve beam width (None = the request's ef) —
    #: the headline speed mode narrows to ef=160 under seeded entry, and
    #: that is a property of the MODE, not of the client's request.
    MODE_KEYS = ("stop_frontier", "stop_patience", "rescore", "max_iters",
                 "entry_seeds", "seed_pool", "ef", "frontier_rank")

    def __init__(self, vectors_np, graph, space, default_ef, default_k, mode,
                 storage=None, deleted=None, stop_frontier=0.0,
                 stop_patience=0, rescore=None, max_iters=0,
                 auto_speed=0.0, entry_seeds=0, seed_pool=0, modes=None):
        import jax
        import jax.numpy as jnp

        from hnsw_tpu.core.graph import graph_device_arrays, pad_vectors, round_up

        from hnsw_tpu.core.spaces import get_space

        # `space` arrives as the checkpoint's persist name (l2 | l2u8 | ip |
        # cosine); resolve the descriptor so the kernels get the dispatch
        # name and incoming queries get the space's preprocessing (cosine
        # normalization / the u8 shift — stored vectors are already
        # preprocessed at build time).
        self.space_obj = get_space(space, vectors_np.shape[1])
        self.space = self.space_obj.name
        self.persist_space = space
        self.mode = mode
        self.storage = storage
        self.default_ef = default_ef
        self.default_k = default_k
        # adaptive-termination speed mode + exact-rescore, service-wide
        # (static under jit — per-request values would compile per value)
        self.stop_frontier = float(stop_frontier)
        self.stop_patience = int(stop_patience)
        self.rescore = rescore  # None = off
        # lockstep hop budget: the batch traverses in lockstep, so batch
        # time = the slowest query's iterations; a hard cap near the p99
        # cuts the straggler tail at ~zero recall cost (0 = uncapped)
        self.max_iters = int(max_iters)
        self.num_nodes = graph.num_nodes
        self.dim = vectors_np.shape[1]
        n_pad = round_up(graph.num_nodes + 1, 128)
        self.dg = graph_device_arrays(graph, n_pad)
        x_np = pad_vectors(vectors_np, n_pad)
        self.x = jnp.asarray(x_np, dtype=jnp.float32)
        self.sq = (
            jnp.sum(self.x * self.x, axis=-1)
            if self.space_obj.needs_sq_norms
            else None
        )
        self.labels_np = np.asarray(jax.device_get(self.dg.labels))
        dev = jax.devices()[0]
        self.device = {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())}
        # markDelete semantics (hnswalg.h:853-900): delete-marked elements
        # must never be returned; HNSWIndex.search does this via an eligible
        # mask and the service must match.
        self.eligible = None
        self._elig_host = None  # host copy, base for per-request filters
        if deleted is not None and np.any(deleted):
            elig = np.ones(n_pad, dtype=bool)
            elig[: len(deleted)] = ~np.asarray(deleted, dtype=bool)
            self._elig_host = elig
            self.eligible = jnp.asarray(elig)
        # landmark-seeded entry (SearchParams.entry_seeds analog): one
        # matmul over the upper-level nodes replaces the greedy descent
        self.entry_seeds = int(entry_seeds)
        self.seed_pool = int(seed_pool)
        self._lm_cache: dict = {}  # pool_extra -> landmark arrays (or None)
        if auto_speed:
            self._calibrate(float(auto_speed))
        # named mode menu: "default" = the flat knobs above (post-
        # calibration); each extra mode overrides a subset of MODE_KEYS and
        # compiles as its own program, routed per request via "mode"
        base = {k: getattr(self, k, None) for k in self.MODE_KEYS}
        self.modes = {"default": base}
        for name, over in (modes or {}).items():
            bad = set(over) - set(self.MODE_KEYS)
            if bad:
                raise ValueError(
                    f"mode {name!r}: unknown keys {sorted(bad)} "
                    f"(allowed: {list(self.MODE_KEYS)})"
                )
            self.modes[name] = {**base, **over}

    def _landmarks(self, pool_extra: int):
        """Landmark arrays for the seeded entry, cached per pool size
        (modes with different seed_pool need different pools)."""
        pool_extra = int(pool_extra)
        if pool_extra not in self._lm_cache:
            from hnsw_tpu.models.hnsw import landmark_arrays

            self._lm_cache[pool_extra] = landmark_arrays(
                self.dg, self.x, self.sq, pool_extra=pool_extra
            )
        return self._lm_cache[pool_extra]

    def warm_modes(self, batch: int = 16):
        """Compile every registered mode once at startup so the first real
        request of any mode never pays a cold jit compile."""
        q = np.zeros((batch, self.dim), dtype=np.float32)
        for name in self.modes:
            self.search(q, self.default_k, self.default_ef, mode=name)

    def _calibrate(self, percentile, frontier=1.15, sample=2048, margin=2):
        """Startup auto-tune of the speed mode (the service twin of
        HNSWIndex.calibrate_speed_mode): probe a frontier-stopped search on
        perturbed stored vectors — the reference's self-query methodology,
        bin/experiment.py:160-234 — and cap the lockstep hop budget at the
        `percentile` tail of the LAST-IMPROVEMENT distribution + `margin`
        (late iterations almost never improve the top-k). Leaves an
        explicit --max_iters untouched."""
        import jax.numpy as jnp

        from hnsw_tpu.ops.traversal import search_batch

        if not self.stop_frontier:
            self.stop_frontier = frontier
        rng = np.random.default_rng(0)
        b = min(sample, self.num_nodes)
        b = max((b // 16) * 16, 16)
        rows = jnp.asarray(
            rng.integers(0, self.num_nodes, size=b).astype(np.int32)
        )
        q = jnp.take(self.x, rows, axis=0) + 0.05 * jnp.asarray(
            rng.standard_normal((b, self.dim)).astype(np.float32)
        )
        res = search_batch(
            self.x, self.dg, q, k=self.default_k,
            ef=max(self.default_ef, self.default_k), space=self.space,
            sq_norms=self.sq, expand=2, eligible=self.eligible,
            has_mask=self.eligible is not None,
            stop_frontier=self.stop_frontier, collect_metrics=True,
            **self._seed_kwargs(
                q, self.default_k, max(self.default_ef, self.default_k)
            ),
        )
        last = np.asarray(res.last_improve)
        cap = int(np.percentile(last, percentile)) + int(margin)
        default_cap = 2 * max(self.default_ef, self.default_k) + 16
        if not self.max_iters and cap < default_cap:
            self.max_iters = cap

    def _seed_kwargs(self, q, k, ef, entry_seeds=None, seed_pool=None):
        """seed_ids/seed_dists for the landmark-seeded entry mode (empty
        dict when off or no landmarks)."""
        entry_seeds = self.entry_seeds if entry_seeds is None else int(entry_seeds)
        seed_pool = self.seed_pool if seed_pool is None else int(seed_pool)
        if entry_seeds <= 0:
            return {}
        lm = self._landmarks(seed_pool)
        if lm is None:
            return {}
        import jax.numpy as jnp

        from hnsw_tpu.ops.topk import bruteforce_topk

        lv, li, lsq = lm
        s = min(entry_seeds, int(li.shape[0]), max(ef, k))
        sd, si = bruteforce_topk(q, lv, s, self.space, x_sq_norms=lsq)
        return {"seed_ids": jnp.take(li, si, axis=0), "seed_dists": sd}

    def search(self, queries: np.ndarray, k: int, ef: int, entry_ids=None,
               mode: str | None = None, filters=None):
        return self.search_resolve(
            self.search_launch(queries, k, ef, entry_ids, mode, filters)
        )

    def _eligible_for(self, filters, b0, b_pad):
        """Eligibility arrays for a batch: the shared deleted-mark mask when
        no request carries a filter, or a per-query [b_pad, n_pad] mask
        (per-request label allowlists — the per-query BaseFilterFunctor
        path, ops/traversal.py _mask_lookup) when any does. Requests with
        and without filters coexist in one micro-batch."""
        if filters is None or not any(f is not None for f in filters):
            return self.eligible
        import jax.numpy as jnp

        n_pad = int(self.dg.level0.shape[0])
        if self._elig_host is None:
            base = np.ones(n_pad, dtype=bool)
        else:
            base = self._elig_host
        mask = np.zeros((b_pad, n_pad), dtype=bool)
        mask[:b0] = base[None, :]
        for i, allow in enumerate(filters):
            if allow is None:
                continue
            row = np.isin(
                self.labels_np, np.asarray(allow, dtype=np.int64)
            )
            mask[i] = row & base
        return jnp.asarray(mask)

    def search_launch(self, queries: np.ndarray, k: int, ef: int,
                      entry_ids=None, mode: str | None = None,
                      filters=None):
        """Dispatch the device search WITHOUT forcing the result (JAX async
        dispatch): returns an opaque handle for search_resolve. Splitting
        launch/resolve lets the micro-batcher overlap batch N's device
        execution with batch N-1's readback."""
        import jax.numpy as jnp

        from hnsw_tpu.ops.traversal import search_batch

        cfg = self.modes[mode or "default"]
        if cfg.get("ef"):
            ef = int(cfg["ef"])
        b0 = queries.shape[0]
        b_pad = ((b0 + 15) // 16) * 16
        q = np.zeros((b_pad, self.dim), dtype=np.float32)
        q[:b0] = self.space_obj.preprocess(queries)
        ent = None
        if entry_ids is not None:
            e = np.zeros(b_pad, dtype=np.int32)
            e[:b0] = entry_ids
            ent = jnp.asarray(e)
        # exact re-rank of the top candidates (the same policy as
        # HNSWIndex.search); the search must RETURN m_res candidates for
        # the rescore to have anything to re-rank
        m_res = min(int(cfg["rescore"] or 0), max(ef, k))
        k_search = max(k, m_res) if m_res >= k else k
        qd = jnp.asarray(q)
        seed_kwargs = {} if ent is not None else self._seed_kwargs(
            qd, k_search, max(ef, k_search),
            entry_seeds=cfg["entry_seeds"], seed_pool=cfg["seed_pool"],
        )
        eligible = self._eligible_for(filters, b0, b_pad)
        res = search_batch(
            self.x,
            self.dg,
            qd,
            k=k_search,
            ef=max(ef, k_search),
            space=self.space,
            sq_norms=self.sq,
            entry_ids=ent,
            expand=2,
            eligible=eligible,
            has_mask=eligible is not None,
            stop_frontier=cfg["stop_frontier"],
            frontier_rank=int(cfg.get("frontier_rank") or 0),
            stop_patience=cfg["stop_patience"],
            max_iters=cfg["max_iters"],
            **seed_kwargs,
        )
        if m_res >= k and m_res > 0:
            from hnsw_tpu.models.hnsw import _rescore_topk

            rd, ri = _rescore_topk(
                jnp.asarray(q), self.x, res.ids, res.dists,
                k=k, m=m_res, space=self.space,
            )
            res = type(res)(rd, ri, res.hops, res.dist_comps)
        return res.dists, res.ids, b0

    def search_resolve(self, handle):
        """Force a search_launch handle to host → (dists, labels)."""
        dists_dev, ids_dev, b0 = handle
        dists = np.asarray(dists_dev)[:b0]
        ids = np.asarray(ids_dev)[:b0]
        labels = np.where(
            np.isfinite(dists), self.labels_np[np.minimum(ids, len(self.labels_np) - 1)], -1
        )
        return dists, labels


class _MicroBatcher:
    """Coalesce concurrent /search requests into one device call."""

    def __init__(self, engine: _Engine, window_ms: float = 2.0, max_batch: int = 256):
        self.engine = engine
        self.window = window_ms / 1000.0
        self.max_batch = max_batch
        self.lock = threading.Lock()
        self.pending: list = []  # (query, k, ef, entry, event, out)
        self.kick = threading.Condition(self.lock)
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def submit(self, query, k, ef, entry_id, mode=None, filter_labels=None):
        ev = threading.Event()
        out = {}
        with self.lock:
            self.pending.append(
                (query, k, ef, entry_id, ev, out, mode, filter_labels)
            )
            self.kick.notify()
        ev.wait()
        if "error" in out:
            raise RuntimeError(out["error"])
        return out["dists"], out["labels"]

    @staticmethod
    def _bucket(k: int, ef: int) -> tuple[int, int]:
        """Quantize (k, ef) up to a power-of-two ladder: clients asking for
        different ef coalesce into ONE device call (computed at the bucket
        ef >= every request's ef — a quality floor, never a cut), and the
        compiled-program count stays O(log^2) instead of one per distinct
        request shape."""
        kb = 1 << (max(k, 1) - 1).bit_length()
        efb = 1 << (max(ef, kb, 1) - 1).bit_length()
        return kb, efb

    def _run(self):
        # 1-deep pipeline: launch batch N's device call (JAX async
        # dispatch), THEN resolve batch N-1's readback while N executes —
        # sustained throughput becomes device-bound instead of paying
        # dispatch+readback serially per batch. `inflight` holds (items, handle) pairs
        # launched but not yet resolved.
        inflight: list = []
        while True:
            with self.lock:
                # resolve any inflight work BEFORE sleeping for new
                # requests — the last batch's waiters must not hang on the
                # arrival of a next one
                while not self.pending and not inflight:
                    self.kick.wait()
                batch = []
                if self.pending:
                    # collect for the window on the condition variable (no
                    # spin-poll): each arrival notifies, the deadline
                    # bounds it
                    deadline = time.time() + self.window
                    while len(self.pending) < self.max_batch:
                        left = deadline - time.time()
                        if left <= 0:
                            break
                        self.kick.wait(timeout=left)
                    batch = self.pending[: self.max_batch]
                    self.pending = self.pending[self.max_batch :]
            # group by the (k, ef) BUCKET + mode to keep shapes static per call
            groups: dict = {}
            for item in batch:
                key = self._bucket(item[1], item[2]) + (item[6],)
                groups.setdefault(key, []).append(item)
            launched: list = []
            for (k, ef, mode), items in groups.items():
                q = np.stack([it[0] for it in items])
                ents = [it[3] for it in items]
                ent = (
                    np.asarray([e if e is not None else -1 for e in ents], np.int32)
                    if any(e is not None for e in ents)
                    else None
                )
                if ent is not None:
                    # -1 falls back to the graph entry point via the
                    # invalid-entry guard only when explicitly overridden;
                    # use graph entry for those rows
                    ent = np.where(ent < 0, int(self.engine.dg.entry_point), ent)
                filts = [it[7] for it in items]
                if not any(f is not None for f in filts):
                    filts = None
                try:
                    h = self.engine.search_launch(
                        q, k, ef, ent, mode=mode, filters=filts
                    )
                except Exception as exc:  # launch-time errors surface now
                    for it in items:
                        it[5]["error"] = str(exc)
                        it[4].set()
                    continue
                launched.append((items, h))
            # resolve the PREVIOUS launches while the new ones execute
            for items, h in inflight:
                try:
                    d, l = self.engine.search_resolve(h)
                    for i, it in enumerate(items):
                        # slice back to the request's own k (bucket k >= it)
                        it[5]["dists"] = d[i][: it[1]]
                        it[5]["labels"] = l[i][: it[1]]
                except Exception as exc:  # surface errors to all waiters
                    for it in items:
                        it[5]["error"] = str(exc)
                for it in items:
                    it[4].set()
            inflight = launched


def _fetch_bulk_vectors(storage: str, dim: int, retries: int = 3):
    """One bulk transfer from the storage service → (ids, vecs), parsed
    STREAMING into preallocated arrays: buffering the whole body and then
    copying it out doubles transient host RSS — the metric the optimized
    mode exists to keep low (reference RSS methodology,
    bin/experiment.py:237-290).

    Retries with linear backoff like the reference's per-vector fetch
    (hnsw_graph.cpp:184-209, retry x3) so a storage service that is still
    coming up or briefly restarting does not kill the query service."""
    import struct

    rec_size = 4 + 4 * dim
    for attempt in range(retries):
        try:
            with urllib.request.urlopen(
                f"{storage}/vec/bulk?dim={dim}", timeout=300
            ) as r:
                head = r.read(8)
                count, d = struct.unpack("<II", head)
                assert d == dim
                buf = np.empty(count * rec_size, dtype=np.uint8)
                got = 0
                total = count * rec_size
                while got < total:
                    chunk = r.read(min(1 << 22, total - got))
                    if not chunk:
                        raise IOError("short bulk body")
                    buf[got : got + len(chunk)] = np.frombuffer(
                        chunk, dtype=np.uint8
                    )
                    got += len(chunk)
            rec = buf.view(
                [("id", "<u4"), ("vec", "<f4", (dim,))]
            )
            return rec["id"].astype(np.int64), rec["vec"]
        except Exception:
            if attempt == retries - 1:
                raise
            time.sleep(1.0 * (attempt + 1))


def build_engine(
    graph_file: str,
    optimized: bool,
    storage: str,
    dim: int,
    ef: int,
    k: int,
    stop_frontier: float = 0.0,
    stop_patience: int = 0,
    rescore: int | None = None,
    max_iters: int = 0,
    auto_speed: float = 0.0,
    entry_seeds: int = 0,
    seed_pool: int = 0,
    modes: dict | None = None,
) -> _Engine:
    speed = dict(
        stop_frontier=stop_frontier, stop_patience=stop_patience,
        rescore=rescore, max_iters=max_iters, auto_speed=auto_speed,
        entry_seeds=entry_seeds, seed_pool=seed_pool, modes=modes,
    )
    if not optimized:
        from hnsw_tpu.io.checkpoint import load_checkpoint

        g, vectors, deleted, meta = load_checkpoint(graph_file)
        return _Engine(
            vectors, g, meta.get("space", "l2"), ef, k, "normal",
            deleted=deleted, **speed,
        )
    # optimized: adjacency-only + vectors from the storage service
    from hnsw_tpu.io.adj import read_adj

    adj_path = graph_file if graph_file.endswith(".adj") else graph_file + ".adj"
    g = read_adj(adj_path)
    ids, vecs = _fetch_bulk_vectors(storage, dim)
    # map storage ids (= labels) onto graph internal order (vectorized)
    sort_idx = np.argsort(ids)
    pos = np.searchsorted(ids, g.labels, sorter=sort_idx)
    order = sort_idx[pos]
    assert np.array_equal(ids[order], g.labels), "storage/graph label mismatch"
    vectors = vecs[order]
    return _Engine(vectors, g, "l2", ef, k, "optimized", storage, **speed)


class QueryHandler(BaseHTTPRequestHandler):
    engine: _Engine = None
    batcher: _MicroBatcher = None
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _json(self, code, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path.startswith("/info"):
            info = {
                "nodes": self.engine.num_nodes,
                "dim": self.engine.dim,
                "ef": self.engine.default_ef,
                "mode": self.engine.mode,
                "space": self.engine.persist_space,
                "device": self.engine.device,
            }
            if self.engine.stop_frontier or self.engine.stop_patience:
                info["stop_frontier"] = self.engine.stop_frontier
                info["stop_patience"] = self.engine.stop_patience
            if self.engine.max_iters:
                info["max_iters"] = self.engine.max_iters
            if self.engine.rescore is not None:
                info["rescore"] = self.engine.rescore
            if self.engine.storage:
                info["storage"] = self.engine.storage
            if len(self.engine.modes) > 1:
                info["modes"] = self.engine.modes
            self._json(200, info)
        elif self.path.startswith("/mem"):
            self._json(200, {"rss_kb": current_rss_kb()})
        else:
            self._json(404, {"error": "not found"})

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        try:
            j = json.loads(self.rfile.read(length))
        except ValueError:
            self._json(400, {"error": "bad json"})
            return
        try:
            if self.path == "/search":
                q = np.asarray(j["query"], dtype=np.float32)
                if q.shape != (self.engine.dim,):
                    self._json(400, {"error": f"query must have dim {self.engine.dim}"})
                    return
                k = int(j.get("k", self.engine.default_k))
                ef = int(j.get("ef", self.engine.default_ef))
                entry = j.get("entry_id")
                mode = j.get("mode")
                if mode is not None and mode not in self.engine.modes:
                    self._json(400, {
                        "error": f"unknown mode {mode!r}",
                        "modes": sorted(self.engine.modes),
                    })
                    return
                # per-request label allowlist (per-query BaseFilterFunctor):
                # requests with different filters coalesce into one batch
                filt = j.get("filter")
                if filt is not None:
                    filt = np.asarray(filt, dtype=np.int64)
                d, l = self.batcher.submit(q, k, ef, entry, mode, filt)
                results = [
                    {"id": int(l[i]), "distance": float(d[i])}
                    for i in range(len(l))
                    if l[i] >= 0
                ]
                resp = {"results": results, "rss_kb": current_rss_kb()}
                if self.engine.mode == "optimized":
                    resp["mode"] = "optimized"
                self._json(200, resp)
            elif self.path == "/search_batch":
                q = np.asarray(j["queries"], dtype=np.float32)
                k = int(j.get("k", self.engine.default_k))
                ef = int(j.get("ef", self.engine.default_ef))
                mode = j.get("mode")
                if mode is not None and mode not in self.engine.modes:
                    self._json(400, {
                        "error": f"unknown mode {mode!r}",
                        "modes": sorted(self.engine.modes),
                    })
                    return
                filts = j.get("filters")
                if filts is not None:
                    filts = [
                        None if f is None else np.asarray(f, dtype=np.int64)
                        for f in filts
                    ]
                d, l = self.engine.search(q, k, ef, mode=mode, filters=filts)
                self._json(
                    200,
                    {
                        "results": [
                            [
                                {"id": int(l[b, i]), "distance": float(d[b, i])}
                                for i in range(l.shape[1])
                                if l[b, i] >= 0
                            ]
                            for b in range(l.shape[0])
                        ],
                        "rss_kb": current_rss_kb(),
                    },
                )
            else:
                self._json(404, {"error": "not found"})
        except Exception as exc:
            self._json(500, {"error": str(exc)})


def serve(engine: _Engine, port: int = 8080):
    QueryHandler.engine = engine
    QueryHandler.batcher = _MicroBatcher(engine)
    httpd = ThreadingHTTPServer(("0.0.0.0", port), QueryHandler)
    print(f"hnsw query service ({engine.mode}) listening on port {port}", flush=True)
    httpd.serve_forever()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="./hnsw_index.npz")
    ap.add_argument("--storage", default="http://127.0.0.1:8081")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--ef", type=int, default=200)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--optimized", default="0")
    ap.add_argument("--dim", type=int, default=128)
    # adaptive-termination speed mode + exact rescore (service-wide: these
    # are static under jit, so per-request values would compile per value)
    ap.add_argument("--stop_frontier", type=float, default=0.0)
    ap.add_argument("--stop_patience", type=int, default=0)
    ap.add_argument("--rescore", type=int, default=None)
    ap.add_argument("--max_iters", type=int, default=0)
    # >0: percentile (e.g. 99) — auto-tune the speed mode at startup by
    # probing the frontier-stopped hop distribution on stored vectors and
    # capping the lockstep hop budget there (no hand tuning needed)
    ap.add_argument("--auto_speed", type=float, default=0.0)
    # >0: landmark-seeded entry — start the beam at the best S upper-level
    # nodes (one matmul) instead of the greedy descent
    ap.add_argument("--entry_seeds", type=int, default=0)
    # >0 (with --entry_seeds): add this many strided level-0 nodes to the
    # landmark pool (closer beam start at ~no extra matmul cost)
    ap.add_argument("--seed_pool", type=int, default=0)
    # named per-request mode menu, e.g.
    # '{"speed": {"stop_frontier": 1.15, "max_iters": 14, "entry_seeds": 4},
    #   "high_recall": {"entry_seeds": 8, "seed_pool": 65536}}'
    # — each mode is precompiled at startup and selected per request via
    # the JSON "mode" field; the flat flags above define "default"
    ap.add_argument("--modes", type=str, default=None)
    # warm (precompile) every mode at startup so no request pays a cold jit
    ap.add_argument("--warm", type=int, default=1)
    # RLIMIT_AS self-cap (reference main.cpp:19-22; the native frontend
    # defaults to 2048). Default 0 = OFF here: the accelerator runtime maps
    # device buffers into the address space, so a blanket cap would kill the
    # engine — opt in for the optimized/CPU modes whose RSS claims the
    # experiment harness audits.
    ap.add_argument("--mem_cap_mb", type=int, default=0)
    args = ap.parse_args()
    from hnsw_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.mem_cap_mb > 0:
        from hnsw_tpu.utils.rss import apply_mem_cap

        if apply_mem_cap(args.mem_cap_mb):
            print(f"RLIMIT_AS capped at {args.mem_cap_mb} MB", flush=True)
    optimized = args.optimized in ("1", "true", "True")
    engine = build_engine(
        args.graph, optimized, args.storage, args.dim, args.ef, args.k,
        stop_frontier=args.stop_frontier, stop_patience=args.stop_patience,
        rescore=args.rescore, max_iters=args.max_iters,
        auto_speed=args.auto_speed, entry_seeds=args.entry_seeds,
        seed_pool=args.seed_pool,
        modes=json.loads(args.modes) if args.modes else None,
    )
    if args.warm:
        engine.warm_modes()
    # all hot state now lives in device memory; return the build-time host
    # buffers (checkpoint arrays / bulk-fetch staging) to the OS so the
    # serving RSS reflects steady state, not the transient peak
    from hnsw_tpu.utils.rss import release_host_memory

    release_host_memory()
    serve(engine, args.port)


if __name__ == "__main__":
    main()
