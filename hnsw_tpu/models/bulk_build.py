"""Device-accelerated bulk index construction.

The reference builds strictly serially: one ef_construction beam search per
inserted point on the CPU (the build hot loop, index_builder/build.cpp:137-145
-> hnswalg.h:954-1267). That search is ~95% of build compute. Here it runs on
the accelerator in geometric waves:

  1. Levels are pre-sampled host-side (same geometric distribution as
     hnswalg.h:207-211). The ~1/M of nodes with level >= 1 are inserted by
     the native host engine (they form the upper hierarchy + seed graph).
  2. The remaining level-0-only nodes are registered unlinked, then linked
     in geometrically growing waves. Per wave:
       a. batched beam search over the current graph snapshot on device
          (search_batch, ef_construction beam) -> candidate lists,
       b. the neighbor-selection heuristic (getNeighborsByHeuristic2
          semantics, hnswalg.h:443-483) vectorized on device: a masked scan
          over candidates with a matmul-computed candidate-candidate distance
          block,
       c. link application (forward + reverse links with overflow re-prune)
          through the native engine (hnsw_connect_batch).

  Nodes within one wave don't see each other as candidates (they search the
  pre-wave snapshot) — the standard staleness tradeoff of batched ANN
  builders; geometric wave growth keeps early (structure-defining) edges
  near-incremental quality.
"""

from __future__ import annotations

import functools
import math
import time

import jax
import jax.numpy as jnp
import numpy as np


from hnsw_tpu.core.spaces import Space, get_space
from hnsw_tpu.ops.traversal import search_batch

Array = jax.Array


@functools.partial(jax.jit, static_argnames=("m", "space"))
def select_neighbors_device(
    vectors: Array,  # [N_pad, D]
    cand_ids: Array,  # [W, C] ascending by distance (sentinel >= num_nodes)
    cand_d: Array,  # [W, C] distance to the new node (inf = invalid)
    num_nodes: Array,
    m: int,
    space: str = "l2",
) -> Array:
    """Vectorized getNeighborsByHeuristic2 (hnswalg.h:443-483): scan
    candidates closest-first, keep one iff it is closer to the new node than
    to every already-kept candidate; stop at m. Returns kept ids [W, m]
    (-1 padded)."""
    w, c = cand_ids.shape
    safe = jnp.where(cand_ids < num_nodes, cand_ids, 0)
    rows = jnp.take(vectors, safe, axis=0)  # [W, C, D]
    # candidate-candidate distances via one batched matmul
    g = jax.lax.dot_general(
        rows, rows, (((2,), (2,)), ((0,), (0,))), preferred_element_type=jnp.float32
    )  # [W, C, C] gram
    if space == "l2":
        sq = jnp.sum(rows.astype(jnp.float32) ** 2, axis=-1)  # [W, C]
        pair = jnp.maximum(sq[:, :, None] + sq[:, None, :] - 2.0 * g, 0.0)
    else:
        pair = 1.0 - g
    valid = (cand_ids < num_nodes) & jnp.isfinite(cand_d)

    def body(j, state):
        keep, count = state  # [W, C] bool, [W]
        # min distance from candidate j to already-kept candidates
        dj = jnp.where(keep, pair[:, j, :], jnp.inf)  # [W, C]
        min_kept = jnp.min(dj, axis=-1)  # [W]
        # keep on ties: the reference rejects only when a kept neighbor is
        # strictly closer to the candidate than the query is
        # (getNeighborsByHeuristic2, hnswalg.h:443-483; builder.cpp:309)
        ok = valid[:, j] & (count < m) & (min_kept >= cand_d[:, j])
        keep = keep.at[:, j].set(ok)
        return keep, count + ok.astype(jnp.int32)

    keep, _ = jax.lax.fori_loop(
        0, c, body, (jnp.zeros((w, c), bool), jnp.zeros((w,), jnp.int32))
    )
    # compact kept ids into [W, m] by sorting (kept first, by distance)
    key = jnp.where(keep, cand_d, jnp.inf)
    _, order = jax.lax.sort(
        (key, jnp.where(keep, cand_ids, -1)), dimension=-1, num_keys=1
    )
    return order[:, :m]


def select_neighbors_host(
    vectors: np.ndarray,  # [N, D] host copy
    cand_ids: np.ndarray,  # [W, C]
    cand_d: np.ndarray,  # [W, C]
    num_nodes: int,
    m: int,
    space: str = "l2",
) -> np.ndarray:
    """NumPy mirror of select_neighbors_device (same
    getNeighborsByHeuristic2 semantics), used by the recursive upper phase
    to prune the sub-graph's level-0 links on the host."""
    w, c = cand_ids.shape
    safe = np.clip(cand_ids, 0, num_nodes - 1)
    rows = vectors[safe]  # [W, C, D]
    g = np.einsum("wcd,wed->wce", rows, rows, optimize=True)
    if space == "l2":
        sq = np.einsum("wcd,wcd->wc", rows, rows)
        pair = np.maximum(sq[:, :, None] + sq[:, None, :] - 2.0 * g, 0.0)
    else:
        pair = 1.0 - g
    valid = (cand_ids < num_nodes) & np.isfinite(cand_d)
    keep = np.zeros((w, c), dtype=bool)
    count = np.zeros(w, dtype=np.int32)
    for j in range(c):
        dj = np.where(keep, pair[:, j, :], np.inf)
        min_kept = dj.min(axis=-1)
        ok = valid[:, j] & (count < m) & (min_kept >= cand_d[:, j])
        keep[:, j] = ok
        count += ok.astype(np.int32)
    key = np.where(keep, cand_d, np.inf)
    order = np.argsort(key, axis=1, kind="stable")
    sel = np.take_along_axis(np.where(keep, cand_ids, -1), order, axis=1)
    return sel[:, :m].astype(np.int32)


def _recursive_upper_phase(
    idx, data, labels, levels, hi, space, m, ef_construction, seed,
    first_wave, select_c, verbose, upper_recurse_min,
    wave_stop_frontier=0.0,
    wave_entry_seeds=0,
    wave_seed_pool=0,
):
    """Build the level>=1 hierarchy by recursing bulk_build on the subset
    (levels shifted down by one), then graft the sub-graph into `idx`'s
    builder via the array importer. Returns the new builder.

    Mapping (sub node j == main node j, since hi is inserted in order):
    - main level-0 links of upper nodes := sub level-0 (cap 2M) — the same
      upper-only initial neighborhood the serial host phase produces; later
      waves re-link them mutually with the rest of the data.
    - main level-1 links := sub level-0 heuristic-pruned to M
      (getNeighborsByHeuristic2 semantics, hnswalg.h:443-483).
    - main level l+1 links := sub level l links, slots reused verbatim.
    """
    from hnsw_tpu.core.graph import HNSWGraph
    from hnsw_tpu.native.hnsw_builder import NativeHNSWBuilder

    nh = len(hi)
    # positional labels: the sub build reorders internally (its own upper
    # nodes insert first) — g_sub.labels[j] recovers input position of sub
    # node j, and everything below is remapped back to input order
    # `data` is already preprocessed by the enclosing bulk_build — hand the
    # sub-build the kernel-dispatch space (plain l2/ip pass-through), not
    # the user space, or a non-idempotent preprocess (the l2u8 shift)
    # would be applied twice
    sub = bulk_build(
        data[hi], labels=np.arange(nh, dtype=np.int64),
        space=get_space(space.name, data.shape[1]), m=m,
        ef_construction=ef_construction, seed=seed + 1,
        first_wave=first_wave, select_c=select_c, verbose=verbose,
        upper_recurse_min=upper_recurse_min, _levels=levels[hi] - 1,
        wave_stop_frontier=wave_stop_frontier,
        wave_entry_seeds=wave_entry_seeds,
        wave_seed_pool=wave_seed_pool,
    )
    g_sub = sub._builder.export_graph()
    xh = np.ascontiguousarray(data[hi], dtype=np.float32)
    perm = np.asarray(g_sub.labels, dtype=np.int64)  # sub id -> input pos
    inv = np.empty(nh, dtype=np.int64)
    inv[perm] = np.arange(nh)  # input pos -> sub id

    def remap(ids):
        return np.where(
            ids >= 0, perm[np.clip(ids, 0, nh - 1)], -1
        ).astype(np.int32)

    # level-0 rows in input order, neighbor ids as input positions
    l0 = remap(np.asarray(g_sub.level0, dtype=np.int32))[inv]  # [nh, 2m]

    # level-1 links: prune each node's 2M level-0 candidates to the best M
    # by the diversity heuristic (chunked: the gathered rows are ~1GB at 1M)
    pruned = np.full((nh, m), -1, dtype=np.int32)
    chunk = 8192
    for s in range(0, nh, chunk):
        e = min(s + chunk, nh)
        ids_c = l0[s:e]
        safe = np.clip(ids_c, 0, nh - 1)
        rows = xh[safe]  # [c, 2m, D]
        qc = xh[s:e][:, None, :]
        if space.name == "l2":
            d_c = ((rows - qc) ** 2).sum(-1)
        else:
            d_c = 1.0 - np.einsum("cmd,cod->cm", rows, qc)
        d_c = np.where(ids_c >= 0, d_c, np.inf).astype(np.float32)
        order = np.argsort(d_c, axis=1, kind="stable")
        ids_s = np.take_along_axis(ids_c, order, axis=1)
        d_s = np.take_along_axis(d_c, order, axis=1)
        pruned[s:e] = select_neighbors_host(
            xh, ids_s, d_s, nh, m, space.name
        )

    L = g_sub.max_level + 1
    lv_main = levels[hi].astype(np.int32)
    upper = np.full((L, nh, m), -1, dtype=np.int32)
    upper_slot = np.full((L, nh), -1, dtype=np.int32)
    upper[0, :, :] = pruned
    upper_slot[0, :] = np.arange(nh, dtype=np.int32)
    for l in range(1, L):
        # sub level l == main level l+1; slot numbering is reused (rows are
        # indexed by slot), only the node ids inside rows and the per-node
        # slot lookups need the input-order remap
        su = remap(np.asarray(g_sub.upper[l - 1], dtype=np.int32))
        upper[l, : su.shape[0], : su.shape[1]] = su
        upper_slot[l, :] = g_sub.upper_slot[l - 1, inv]

    g_main = HNSWGraph(
        level0=l0,
        upper=upper,
        upper_slot=upper_slot,
        node_level=lv_main,
        labels=np.asarray(labels[hi], dtype=np.int64),
        entry_point=int(perm[g_sub.entry_point]),
        max_level=L,
    )
    b_new = NativeHNSWBuilder.from_graph(
        g_main, xh, None, space=space.name,
        ef_construction=ef_construction, seed=seed,
    )
    idx._builder = b_new
    return b_new


def _data_fingerprint(data: np.ndarray) -> str:
    """Cheap input-data identity for checkpoint resume validation: hash of
    the first and last rows plus the shape (full-array hashing would cost
    seconds at 1M; corrupt partial overlap with identical endpoints is not a
    realistic failure here)."""
    import hashlib

    h = hashlib.sha1()
    h.update(np.asarray(data.shape, np.int64).tobytes())
    if data.size:
        h.update(np.ascontiguousarray(data[0]).tobytes())
        h.update(np.ascontiguousarray(data[-1]).tobytes())
    return h.hexdigest()[:16]


def bulk_build(
    data: np.ndarray,
    labels: np.ndarray | None = None,
    space: Space | str = "l2",
    m: int = 16,
    ef_construction: int = 200,
    seed: int = 123,
    first_wave: int = 4096,
    select_c: int = 64,
    verbose: bool = False,
    checkpoint: str | None = None,
    checkpoint_every_s: float = 180.0,
    upper_recurse_min: int = 20_000,
    wave_size: int | None = None,
    wave_stop_frontier: float = 0.0,
    wave_entry_seeds: int = 0,
    wave_seed_pool: int = 0,
    _levels: np.ndarray | None = None,
):
    """Build an HNSWIndex with device-accelerated construction.

    Returns the HNSWIndex (host engine fully populated: incremental
    insert/update/delete and persistence all work afterwards).

    `checkpoint`: path prefix for periodic elastic-recovery saves (at a
    wave boundary once `checkpoint_every_s` of build work has elapsed since
    the last save, so a large save does not dominate late waves). If
    `<checkpoint>.npz` + `<checkpoint>.state.json` exist, the build RESUMES
    from the saved wave cursor — the level sampling is deterministic in
    `seed`, so the node-id assignment replays exactly. A build that dies
    (host or device failure) restarts and loses at most
    `checkpoint_every_s` of work. Reference failure-handling analog: fetch
    retry x3 (hnsw_graph.cpp:184-209); this also survives process death.
    """
    import json
    import os

    from hnsw_tpu.models.hnsw import HNSWIndex, landmark_arrays
    from hnsw_tpu.ops.topk import bruteforce_topk

    if isinstance(space, str):
        space = get_space(space, data.shape[1])
    data = space.preprocess(data)
    n = data.shape[0]
    if labels is None:
        labels = np.arange(n, dtype=np.int64)
    labels = np.asarray(labels, dtype=np.int64)

    if _levels is None:
        rng = np.random.default_rng(seed)
        # 1) pre-sample levels (hnswalg.h:207-211 distribution)
        mult = 1.0 / math.log(m)
        levels = np.floor(-np.log(rng.uniform(size=n)) * mult).astype(np.int32)
    else:
        levels = np.asarray(_levels, dtype=np.int32)
    hi = np.where(levels >= 1)[0]
    lo = np.where(levels == 0)[0]
    if verbose:
        print(f"bulk_build: {len(hi)} upper nodes (host), {len(lo)} level-0 (device)")

    state_path = f"{checkpoint}.state.json" if checkpoint else None
    ckpt_path = f"{checkpoint}.npz" if checkpoint else None
    resume_pos = resume_wave = None
    if checkpoint and os.path.exists(state_path) and os.path.exists(ckpt_path):
        with open(state_path) as f:
            st = json.load(f)
        # full config + cheap data fingerprint: a stale checkpoint at the
        # same path from a different dataset/config must NOT silently resume
        # (vectors replay from the NEW data against the OLD graph)
        if (
            st.get("n") == n
            and st.get("seed") == seed
            and st.get("m") == m
            and st.get("dim") == int(data.shape[1])
            and st.get("space") == space.persist_name
            and st.get("efc") == ef_construction
            and st.get("fp") == _data_fingerprint(data)
        ):
            from hnsw_tpu.io.checkpoint import load_checkpoint
            from hnsw_tpu.native.hnsw_builder import NativeHNSWBuilder

            g, vecs_ck, deleted_ck, _meta = load_checkpoint(ckpt_path)
            if vecs_ck.shape[1] == 0:
                # graph-only checkpoint: vectors replay deterministically in
                # insertion order (upper nodes first, then registered level-0)
                order = np.concatenate([hi, lo])[: g.num_nodes]
                vecs_ck = np.ascontiguousarray(data[order])
            idx = HNSWIndex(space, m=m, ef_construction=ef_construction,
                            seed=seed)
            idx.growth_headroom = 0.0
            idx._builder = NativeHNSWBuilder.from_graph(
                g, vecs_ck, deleted_ck, space=space.name,
                ef_construction=ef_construction,
            )
            b = idx._builder
            resume_pos, resume_wave = st["pos"], st["wave"]
            if verbose:
                print(f"  resume: wave cursor pos={resume_pos} of {len(lo)}")
        elif verbose:
            print("  checkpoint config mismatch — rebuilding from scratch")

    if resume_pos is None:
        idx = HNSWIndex(space, m=m, ef_construction=ef_construction, seed=seed)
        idx.growth_headroom = 0.0  # N is fixed for the whole build
        b = idx._builder

        t0 = time.time()
        if len(hi) >= upper_recurse_min:
            # Recursive upper phase: the level>=1 subset with every level
            # decremented IS an HNSW of the subset (the geometric level
            # distribution is self-similar), so build it with the same
            # device-wave machinery instead of ~N/M serial host inserts
            # (151s of a 650s 1M build), then graft its graph in as the
            # main hierarchy: sub level-0 (cap 2M) becomes the upper nodes'
            # initial main level-0 links AND, heuristic-pruned to M, the
            # main level-1 links; sub level l becomes main level l+1.
            b = _recursive_upper_phase(
                idx, data, labels, levels, hi, space, m, ef_construction,
                seed, first_wave, select_c, verbose, upper_recurse_min,
                wave_stop_frontier=wave_stop_frontier,
                wave_entry_seeds=wave_entry_seeds,
                wave_seed_pool=wave_seed_pool,
            )
        else:
            # host-insert the hierarchy seed (small: ~N/M of the data)
            for i in hi:
                b.add_with_level(data[i], int(labels[i]), int(levels[i]))
        if verbose:
            print(f"  upper phase: {time.time() - t0:.1f}s")

        # 2) register level-0 nodes unlinked (so ALL vectors exist now: the
        # device vector table uploads once, and per-wave only the touched
        # level-0 rows move through the incremental sync)
        first_id = b.register_level0_batch(data[lo], labels[lo])
    else:
        first_id = len(hi)
    ids_lo = np.arange(first_id, first_id + len(lo), dtype=np.uint32)

    def save_state(pos, wave):
        if not checkpoint:
            return
        from hnsw_tpu.io.checkpoint import save_checkpoint

        t0 = time.time()
        # atomic: a crash mid-save must not corrupt the resume point.
        # graph-only (vectors replay from `data` on resume): ~2.3x faster
        # writes, the dominant cost of a checkpointed 1M build
        save_checkpoint(
            ckpt_path + ".tmp.npz",
            b.export_graph(),
            np.zeros((0, 0), np.float32),
            b.export_deleted(),
            meta={"space": space.persist_name, "dim": space.dim, "m": m,
                  "ef_construction": ef_construction},
            compress=False,
            include_vectors=False,
        )
        os.replace(ckpt_path + ".tmp.npz", ckpt_path)
        with open(state_path + ".tmp", "w") as f:
            json.dump(
                {
                    "pos": pos, "wave": wave, "n": n, "seed": seed, "m": m,
                    "dim": int(data.shape[1]), "space": space.persist_name,
                    "efc": ef_construction, "fp": _data_fingerprint(data),
                },
                f,
            )
        os.replace(state_path + ".tmp", state_path)
        if verbose:
            print(f"  checkpoint @pos={pos}: {time.time() - t0:.1f}s")

    # 3) wave linking: first_wave, then fixed-size waves (static shapes ->
    # the search/select programs compile once). Device state is maintained
    # across waves by HNSWIndex._sync_device: the first sync uploads
    # everything, each later wave applies only the connect_batch row deltas
    # (dirty-node tracking in the native engine).
    if wave_size is None:
        wave_size = max(first_wave * 4, 1024)
    k_sel = min(select_c, ef_construction)

    def wave_link(rows, ids):
        cnt = len(rows)
        t0 = time.time()
        idx._dirty = True
        dg, x, sq, _, _ = idx._sync_device()
        t_sync = time.time() - t0
        t0 = time.time()
        q_np = data[rows]
        # Pad tail waves up to the doubling-ladder shapes the full waves
        # already compiled (first_wave*2^i, capped at wave_size): an odd
        # tail like 6545 would otherwise trigger a fresh XLA compile of the
        # whole search program for a wave that runs in seconds. Dummy zero
        # queries ride along and are sliced off before connect_batch.
        b_pad = ((cnt + 15) // 16) * 16
        ladder = first_wave
        while ladder < b_pad and ladder < wave_size:
            ladder *= 2
        if b_pad > ladder:  # cnt exceeds the ladder cap (custom wave_size)
            ladder = b_pad
        b_pad = min(ladder, max(((wave_size + 15) // 16) * 16, b_pad))
        if b_pad != cnt:
            q_np = np.concatenate(
                [q_np, np.zeros((b_pad - cnt, data.shape[1]), np.float32)]
            )

        def search_step():
            # Landmark-seeded wave entry (same mechanism as
            # SearchParams.entry_seeds): one matmul over the upper-level
            # nodes replaces the greedy descent and shortens the beam's
            # last-improve tail, letting frontier-stop waves terminate
            # earlier. The upper hierarchy is fixed before waves start, but
            # x/dg are re-synced per wave, so seeds are computed here.
            seed_kwargs = {}
            if wave_entry_seeds > 0 and dg.max_level > 0:
                # wave_seed_pool: strided already-inserted level-0 nodes
                # join the pool (SearchParams.seed_pool analog)
                lm = landmark_arrays(dg, x, sq, pool_extra=wave_seed_pool)
                if lm is not None:
                    lv, li, lsq = lm
                    s = min(wave_entry_seeds, int(li.shape[0]), k_sel)
                    sd, si = bruteforce_topk(
                        jnp.asarray(q_np), lv, s, space.name, x_sq_norms=lsq
                    )
                    seed_kwargs = {
                        "seed_ids": jnp.take(li, si, axis=0),
                        "seed_dists": sd,
                    }
            res = search_batch(
                x,
                dg,
                jnp.asarray(q_np),
                k=k_sel,
                ef=ef_construction,
                space=space.name,
                sq_norms=sq,
                expand=2,
                stop_frontier=wave_stop_frontier,
                **seed_kwargs,
            )
            # Keep the padded batch shape: select compiles per [W, C] too,
            # so dummy rows flow through it and are sliced before linking.
            return (
                np.asarray(jax.device_get(res.ids)),
                np.asarray(jax.device_get(res.dists)),
            )

        ids_np, d_np = search_step()
        sel_np = np.asarray(jax.device_get(select_neighbors_device(
            x, jnp.asarray(ids_np), jnp.asarray(d_np), dg.num_nodes, m,
            space.name,
        )))
        t_dev = time.time() - t0
        t0 = time.time()
        b.connect_batch(ids, sel_np[:cnt])
        if verbose:
            print(
                f"  wave {cnt}: sync {t_sync:.1f}s device {t_dev:.1f}s "
                f"link {time.time() - t0:.1f}s"
            )

    pos = resume_pos or 0
    wave = resume_wave or first_wave
    if resume_pos is None:
        save_state(0, first_wave)  # checkpoint the (expensive) upper phase
    last_save = time.time()
    while pos < len(lo):
        cnt = min(wave, len(lo) - pos)
        wave_link(lo[pos : pos + cnt], ids_lo[pos : pos + cnt])
        pos += cnt
        wave = min(wave * 2, wave_size)
        if pos < len(lo) and time.time() - last_save > checkpoint_every_s:
            save_state(pos, wave)
            last_save = time.time()

    # NOTE a final "polish" re-link of the early (stale-snapshot) waves was
    # tried and made queries SLOWER at equal recall: re-linked nodes get a
    # fresh M-capped forward row but, being last, never receive the reverse
    # links that mature organic nodes toward maxM0 — their degree halves.
    # waves link against stale snapshots, so some nodes end with no inbound
    # level-0 edge; re-attach them before the graph serves
    b.repair_orphans()
    idx.growth_headroom = 1 / 16  # restore post-build insert headroom
    idx._dirty = True
    if checkpoint:
        save_state(len(lo), wave)
    return idx
