"""Batched HNSW graph traversal — the flagship device kernel.

The reference's query path (hnswlib::HierarchicalNSW::searchKnn,
hnswlib/hnswalg.h:1271-1324) is a serial pointer-chase: greedy 1-best descent
over upper layers (1278-1303), then a heap-driven best-first beam over level 0
(searchBaseLayerST, 311-440) with an epoch-tagged visited array
(visited_list_pool.h). None of that batches.

This module re-expresses it as a *batched, fixed-shape, masked* program under
`jit`:

- A hop gathers the chosen nodes' neighbor ids and their vector rows and
  computes all distances at once (hnsw_tpu/ops/hop.py).
- There is no [B, N] visited array. Dedup is an O(EM * (ef + H)) vectorized
  membership test of new candidates against the beam and a short ring
  history of recently expanded ids. (Semantics: a node that was expanded,
  evicted, and forgotten by the ring may be re-scored — wasted work only,
  never a duplicate result, since beam membership is always checked.)
- Beam updates merge a sorted beam with the new candidate block, with the
  expanded flag packed into the id payload (id*2+flag).
- All within-beam selections use one-hot compare-reduce instead of gather.

Per-query hop and distance-computation counters (the reference's
metric_hops / metric_distance_computations, hnswalg.h:65-66) are carried in
the loop state and returned when `collect_metrics=True`.

Filtering (BaseFilterFunctor semantics, hnswlib/hnswlib.h:128-132) and
delete-marks (hnswalg.h:853-900) are an `eligible` mask over node ids:
ineligible nodes are traversed but only eligible ones enter the separate
result list — exactly the reference's searchBaseLayerST behavior for
deleted/filtered points.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from hnsw_tpu.core.graph import DeviceGraph
from hnsw_tpu.ops.distance import gather_dist
from hnsw_tpu.ops.hop import hop_dist

Array = jax.Array

_INF = jnp.inf


class SearchResults(NamedTuple):
    dists: Array  # [B, k] f32, ascending (inf for missing)
    ids: Array  # [B, k] int32 internal ids (>= num_nodes for missing)
    hops: Array  # [B] int32 (zeros unless collect_metrics)
    dist_comps: Array  # [B] int32 (zeros unless collect_metrics)
    # [B] int32: last iteration (1-based) at which the query's k-th best
    # distance improved (zeros unless collect_metrics). Late iterations
    # almost never improve the top-k, so this distribution's tail — not the
    # stop-iteration tail — is the right place to set the lockstep hop
    # budget (calibrate_speed_mode uses it).
    last_improve: Array | None = None


# ---------------------------------------------------------------------------
# Upper-layer greedy descent (reference: hnswalg.h:1278-1303).
# ---------------------------------------------------------------------------


def _greedy_descent_level(
    q, vectors, sq_norms, nbr_table, slot_map, cur, cur_d, num_nodes, space
):
    """Batched greedy 1-best walk on one upper level until no query improves."""

    def cond(state):
        _, _, improved = state
        return jnp.any(improved)

    def body(state):
        cur, cur_d, _ = state
        slots = jnp.take(slot_map, cur, axis=0)  # [B]
        nbrs = jnp.take(nbr_table, slots, axis=0)  # [B, M]
        valid = nbrs < num_nodes
        safe = jnp.where(valid, nbrs, 0)
        d = gather_dist(q, vectors, safe, space, x_sq_norms=sq_norms)
        d = jnp.where(valid, d, _INF)
        best = jnp.argmin(d, axis=-1)  # [B]
        onehot = (
            jax.lax.broadcasted_iota(jnp.int32, d.shape, 1) == best[:, None]
        )
        best_d = jnp.min(d, axis=-1)
        best_id = jnp.sum(jnp.where(onehot, nbrs, 0), axis=-1)
        improved = best_d < cur_d
        cur = jnp.where(improved, best_id, cur)
        cur_d = jnp.where(improved, best_d, cur_d)
        return cur, cur_d, improved

    init = (cur, cur_d, jnp.ones(cur.shape, dtype=bool))
    cur, cur_d, _ = jax.lax.while_loop(cond, body, init)
    return cur, cur_d


# ---------------------------------------------------------------------------
# Level-0 batched beam search (reference: hnswalg.h:311-440).
# ---------------------------------------------------------------------------


def _bitonic_merge_topk(
    beam_d: Array,  # [B, ef] ascending
    beam_p: Array,  # [B, ef] int32 payload
    new_d: Array,  # [B, EM] unsorted (inf = invalid)
    new_p: Array,  # [B, EM] int32 payload
    ef: int,
    pad_p: int,
):
    """Merge a sorted beam with a small unsorted candidate block, keep the
    smallest ef. A generic lax.sort over ef+EM entries costs ~log^2(W)
    compare-exchange stages; here the new block is sorted (cheap at EM~64)
    and spliced as [beam asc | +inf pad | new desc] — a bitonic sequence —
    so one log2(W)-stage bitonic merge finishes the job (~4x fewer stages,
    and this sort was the single largest op in the query loop)."""
    b, em = new_d.shape
    sn_d, sn_p = jax.lax.sort((new_d, new_p), dimension=-1, num_keys=1)
    w = 1 << (ef + em - 1).bit_length()
    pad = w - ef - em
    parts_d = [beam_d]
    parts_p = [beam_p]
    if pad:
        parts_d.append(jnp.full((b, pad), _INF, beam_d.dtype))
        parts_p.append(jnp.full((b, pad), pad_p, beam_p.dtype))
    parts_d.append(sn_d[:, ::-1])
    parts_p.append(sn_p[:, ::-1])
    d = jnp.concatenate(parts_d, axis=-1)  # [B, W] bitonic
    p = jnp.concatenate(parts_p, axis=-1)
    step = w // 2
    while step >= 1:
        d2 = d.reshape(b, -1, 2, step)
        p2 = p.reshape(b, -1, 2, step)
        a, c = d2[:, :, 0], d2[:, :, 1]
        pa, pc = p2[:, :, 0], p2[:, :, 1]
        take_a = a <= c
        lo = jnp.where(take_a, a, c)
        hi = jnp.where(take_a, c, a)
        plo = jnp.where(take_a, pa, pc)
        phi = jnp.where(take_a, pc, pa)
        d = jnp.stack([lo, hi], axis=2).reshape(b, w)
        p = jnp.stack([plo, phi], axis=2).reshape(b, w)
        step //= 2
    return d[:, :ef], p[:, :ef]


def _mask_lookup(eligible: Array, ids: Array) -> Array:
    """Eligibility lookup for candidate ids. `eligible` is either a shared
    [N_pad] mask or a per-query [B, N_pad] mask — the batched analog of the
    reference evaluating BaseFilterFunctor per query (hnswlib/hnswlib.h:
    128-132): every query in the batch can carry its own allowlist (e.g.
    per-tenant serving filters)."""
    if eligible.ndim == 2:
        if ids.ndim == 1:
            return jnp.take_along_axis(eligible, ids[:, None], axis=1)[:, 0]
        return jnp.take_along_axis(eligible, ids, axis=1)
    return jnp.take(eligible, ids, axis=0)


class _BeamState(NamedTuple):
    beam_d: Array  # [B, ef] ascending
    beam_key: Array  # [B, ef] int32: id*2 + expanded_flag
    hist: Array  # [B, H] recently expanded ids
    res_d: Array  # [B, ef] filtered results (unused when no mask)
    res_id: Array  # [B, ef]
    hops: Array  # [B]
    dist_comps: Array  # [B]
    it: Array  # []
    kd_prev: Array  # [B] k-th best distance last iteration (adaptive stop)
    stall: Array  # [B] iterations without top-k improvement
    done: Array  # [B] per-query early-stop flag
    last_improve: Array  # [B] last iteration the top-k improved (metrics)


class StopView(NamedTuple):
    """Read-only view of the per-query beam state handed to a custom stop
    condition — the device analog of hnswlib's BaseSearchStopCondition
    (hnswlib/hnswlib.h:134-150): where the reference's interface inspects
    each candidate on a serial heap, a batched traversal evaluates one
    vectorized predicate over the whole beam per iteration."""

    beam_d: Array  # [B, ef] current beam distances, ascending
    beam_ids: Array  # [B, ef] current beam ids
    res_d: Array  # [B, ef] filtered result distances (== beam when no mask)
    it: Array  # [] iteration counter
    hops: Array  # [B] per-query hop count (when collect_metrics)


@functools.partial(
    jax.jit,
    static_argnames=(
        "k",
        "ef",
        "expand",
        "space",
        "max_iters",
        "collect_metrics",
        "has_mask",
        "hist_len",
        "stop_patience",
        "stop_frontier",
        "frontier_rank",
        "stop_fn",
    ),
)
def search_batch(
    vectors: Array,  # [N_pad, D]
    graph: DeviceGraph,
    queries: Array,  # [B, D]
    *,
    k: int,
    ef: int,
    space: str = "l2",
    sq_norms: Array | None = None,
    eligible: Array | None = None,  # [N_pad] bool shared mask, or [B, N_pad]
    #   bool per-query masks; None => all eligible
    entry_ids: Array | None = None,  # [B] int32 per-query entry override
    seed_ids: Array | None = None,  # [B, S] int32 multi-seed beam init:
    #   skip the upper-layer descent and start the beam at these ids (must
    #   be DISTINCT per query; dists ascending). The landmark-seeding entry
    #   mode (HNSWIndex SearchParams.entry_seeds) computes these with one
    #   matmul against all upper-level nodes — an exact argmin over the
    #   1/M-sampled landmark set, where the greedy descent is approximate.
    seed_dists: Array | None = None,  # [B, S] f32 distances for seed_ids
    expand: int = 1,
    max_iters: int = 0,  # 0 => default 2*ef + 16
    hist_len: int = 0,  # 0 => default ef
    collect_metrics: bool = False,
    has_mask: bool = False,
    stop_patience: int = 0,  # >0: stop a query after this many iterations
    #   without top-k improvement (adaptive-termination speed mode)
    stop_frontier: float = 0.0,  # >0: stop a query once its best UNexpanded
    #   beam entry is farther than stop_frontier * its frontier_rank-th best
    #   distance — the reference's lower_bound-vs-candidate cut
    #   (hnswalg.h:342-436) relaxed by a multiplier (1.0 = classic greedy
    #   cut; ~2-4 = mild)
    frontier_rank: int = 0,  # beam rank the frontier compares against.
    #   0 => k (the aggressive speed-mode cut: the k-th best pins the
    #   threshold no matter how wide the beam is, so widening ef past ~k
    #   buys nothing — measured at 20k: ef 320->768 all saturate at 0.962
    #   recall while the exhaustive ef512 beam reaches 0.983).
    #   ef => hnswlib's own lower bound (the WORST of the ef-sized result
    #   heap, hnswalg.h:342-436): the cut loosens as the beam widens, which
    #   is what makes ef a recall lever again — the high-recall serving
    #   modes use this with stop_frontier ~1.0-1.15.
    stop_fn=None,  # optional StopView -> [B] bool custom stop condition
    #   (BaseSearchStopCondition analog, hnswlib/hnswlib.h:134-150)
) -> SearchResults:
    """Batched HNSW search over a device-resident padded-CSR graph.

    Functional equivalent of HierarchicalNSW::searchKnn
    (hnswlib/hnswalg.h:1271-1324) for a batch of queries: greedy upper-layer
    descent then fixed-ef beam search at level 0. `ef >= k` required.

    Early termination: the fixed-ef loop normally runs until every beam
    entry is expanded (the batch analog of exhausting hnswlib's candidate
    heap, hnswalg.h:342-436). `stop_patience` ends a query once its k-th
    best distance hasn't improved for that many iterations (fewer
    expansions per query). `stop_fn` generalizes this to arbitrary
    pluggable conditions over the beam state.
    """
    assert ef >= k, "ef must be >= k"
    if max_iters <= 0:
        max_iters = 2 * ef + 16
    if hist_len <= 0:
        hist_len = ef
    b, _ = queries.shape
    n_pad, max_m0 = graph.level0.shape
    em = expand * max_m0
    num_nodes = graph.num_nodes
    sent = n_pad - 1
    q = queries

    use_mask = has_mask and eligible is not None
    if eligible is None:
        eligible = jnp.ones((1,), dtype=bool)  # placeholder, unused

    # ---- entry ------------------------------------------------------------
    if seed_ids is not None:
        # Multi-seed init: the beam starts at the caller's seeds (sorted in
        # by a bitonic merge against an empty beam) and the upper-layer
        # descent is skipped entirely — the seeds already are the best
        # entry candidates (see SearchParams.entry_seeds).
        sid = seed_ids.astype(jnp.int32)
        s_ok = (sid >= 0) & (sid < num_nodes)
        sid = jnp.where(s_ok, sid, sent)
        sd = jnp.where(s_ok, seed_dists, _INF)
        beam_d = jnp.full((b, ef), _INF)
        beam_key = jnp.full((b, ef), sent * 2, dtype=jnp.int32)
        beam_d, beam_key = _bitonic_merge_topk(
            beam_d, beam_key, sd, sid * 2, ef, sent * 2
        )
        res_d = jnp.full((b, ef), _INF)
        res_id = jnp.full((b, ef), sent, dtype=jnp.int32)
        if use_mask:
            e_ok = _mask_lookup(eligible, sid) & (sd < _INF)
            res_d, res_id = _bitonic_merge_topk(
                res_d,
                res_id,
                jnp.where(e_ok, sd, _INF),
                jnp.where(e_ok, sid, sent),
                ef,
                sent,
            )
        return _beam_level0(
            q, graph, beam_d, beam_key, res_d, res_id, vectors, sq_norms,
            eligible,
            k=k, ef=ef, space=space, expand=expand, max_iters=max_iters,
            hist_len=hist_len, collect_metrics=collect_metrics,
            use_mask=use_mask,
            stop_patience=stop_patience, stop_frontier=stop_frontier,
            frontier_rank=frontier_rank, stop_fn=stop_fn,
        )

    ep = jnp.broadcast_to(graph.entry_point, (b,)).astype(jnp.int32)
    if entry_ids is None:
        cur = ep
    else:
        # invalid/negative overrides fall back to the graph entry point (a
        # shard without the requested entry label still answers the query)
        e = entry_ids.astype(jnp.int32)
        cur = jnp.where((e >= 0) & (e < num_nodes), e, ep)
    # Guard an empty graph (entry_point -1): park on the dummy row with inf
    # distance so it can never win a merge.
    ent_ok = (cur >= 0) & (cur < num_nodes)
    cur = jnp.where(ent_ok, cur, sent)
    cur_d = gather_dist(q, vectors, cur[:, None], space, x_sq_norms=sq_norms)[:, 0]
    cur_d = jnp.where(ent_ok, cur_d, _INF)

    # ---- upper layers (static python loop over levels) --------------------
    for level in range(graph.max_level, 0, -1):
        cur, cur_d = _greedy_descent_level(
            q,
            vectors,
            sq_norms,
            graph.upper[level - 1],
            graph.upper_slot[level - 1],
            cur,
            cur_d,
            num_nodes,
            space,
        )

    # ---- level-0 beam ------------------------------------------------------
    beam_d = jnp.full((b, ef), _INF)
    beam_key = jnp.full((b, ef), sent * 2, dtype=jnp.int32)
    beam_d = beam_d.at[:, 0].set(cur_d)
    beam_key = beam_key.at[:, 0].set(cur * 2)

    res_d = jnp.full((b, ef), _INF)
    res_id = jnp.full((b, ef), sent, dtype=jnp.int32)
    if use_mask:
        e_ok = _mask_lookup(eligible, cur) & (cur_d < _INF)
        res_d = res_d.at[:, 0].set(jnp.where(e_ok, cur_d, _INF))
        res_id = res_id.at[:, 0].set(jnp.where(e_ok, cur, sent))

    return _beam_level0(
        q, graph, beam_d, beam_key, res_d, res_id, vectors, sq_norms,
        eligible,
        k=k, ef=ef, space=space, expand=expand, max_iters=max_iters,
        hist_len=hist_len, collect_metrics=collect_metrics,
        use_mask=use_mask,
        stop_patience=stop_patience, stop_frontier=stop_frontier,
        frontier_rank=frontier_rank, stop_fn=stop_fn,
    )


def _beam_level0(
    q, graph, beam_d, beam_key, res_d, res_id, vectors, sq_norms, eligible,
    *, k, ef, space, expand, max_iters, hist_len, collect_metrics, use_mask,
    stop_patience, stop_frontier, stop_fn, frontier_rank=0,
) -> SearchResults:
    """The fixed-ef masked beam loop over level 0 (reference:
    searchBaseLayerST, hnswalg.h:311-440), starting from an initialized
    (sorted) beam — one seed from the greedy descent in the classic path,
    S landmark seeds in the entry_seeds path."""
    b = q.shape[0]
    n_pad, max_m0 = graph.level0.shape
    em = expand * max_m0
    num_nodes = graph.num_nodes
    sent = n_pad - 1

    hist = jnp.full((b, hist_len), sent, dtype=jnp.int32)

    iota_ef = jax.lax.broadcasted_iota(jnp.int32, (b, ef), 1)

    use_stop = stop_patience > 0 or stop_frontier > 0 or stop_fn is not None

    def cond(st: _BeamState):
        unexp = (st.beam_key & 1) == 0
        live = unexp & (st.beam_d < _INF)
        alive = jnp.any(live, axis=-1)
        if use_stop:
            alive = alive & ~st.done
        return jnp.logical_and(st.it < max_iters, jnp.any(alive))

    def body(st: _BeamState):
        beam_id = st.beam_key >> 1
        beam_exp = (st.beam_key & 1) == 1
        unexp = (~beam_exp) & (st.beam_d < _INF)
        active = jnp.any(unexp, axis=-1)  # [B]
        if use_stop:
            active = active & ~st.done

        # Select the `expand` best unexpanded entries (beam is sorted).
        key = jnp.where(unexp, st.beam_d, _INF)
        sel_d, sel = jax.lax.top_k(-key, expand)  # [B, E]
        sel_valid = sel_d > -_INF
        onehot = iota_ef[:, None, :] == sel[:, :, None]  # [B, E, ef]
        onehot = onehot & sel_valid[:, :, None]
        chosen = jnp.sum(jnp.where(onehot, beam_id[:, None, :], 0), axis=-1)
        chosen = jnp.where(sel_valid, chosen, sent)  # [B, E]
        new_exp = jnp.any(onehot, axis=1)  # [B, ef]
        beam_key2 = st.beam_key | new_exp.astype(jnp.int32)

        d, nbrs = hop_dist(
            q, vectors, graph.level0, chosen, space, sq_norms=sq_norms
        )

        in_range = nbrs < num_nodes
        # Dedup: candidate already in beam, in recent history, or duplicated
        # earlier within this hop's candidate block (E > 1 only).
        in_beam = jnp.any(
            nbrs[:, :, None] == beam_id[:, None, :], axis=-1
        )
        in_hist = jnp.any(nbrs[:, :, None] == st.hist[:, None, :], axis=-1)
        fresh = in_range & ~in_beam & ~in_hist & active[:, None]
        if expand > 1:
            eq = nbrs[:, :, None] == nbrs[:, None, :]  # [B, EM, EM]
            earlier = (
                jax.lax.broadcasted_iota(jnp.int32, (1, em, em), 2)
                < jax.lax.broadcasted_iota(jnp.int32, (1, em, em), 1)
            )
            dup_earlier = jnp.any(eq & earlier & fresh[:, None, :], axis=-1)
            fresh = fresh & ~dup_earlier

        d = jnp.where(fresh, d, _INF)
        cand_key = jnp.where(fresh, nbrs * 2, sent * 2)

        # Merge into the sorted beam (bitonic merge, not a full re-sort).
        beam_d2, beam_key3 = _bitonic_merge_topk(
            st.beam_d, beam_key2, d, cand_key, ef, sent * 2
        )

        # Push chosen into the ring history.
        hist2 = jnp.concatenate([chosen, st.hist[:, :-expand]], axis=-1)

        if use_mask:
            safe_n = jnp.where(nbrs < n_pad, nbrs, sent)
            ok = _mask_lookup(eligible, safe_n) & fresh
            rd = jnp.where(ok, d, _INF)
            ri = jnp.where(ok, nbrs, sent)
            res_d2, res_id2 = _bitonic_merge_topk(
                st.res_d, st.res_id, rd, ri, ef, sent
            )
        else:
            res_d2, res_id2 = st.res_d, st.res_id

        kd_prev, stall, done = st.kd_prev, st.stall, st.done
        last_improve = st.last_improve
        if use_stop or collect_metrics:
            # top-k improvement <=> the k-th best distance decreased
            # (sorted beam: any entrant into the top k lowers it)
            kd = (res_d2 if use_mask else beam_d2)[:, k - 1]
            improved = (kd < kd_prev) & active
            kd_prev = kd

        if collect_metrics:
            hops = st.hops + active.astype(jnp.int32)
            dist_comps = st.dist_comps + jnp.sum(fresh, axis=-1).astype(jnp.int32)
            last_improve = jnp.where(improved, st.it + 1, last_improve)
        else:
            hops, dist_comps = st.hops, st.dist_comps

        if use_stop:
            if stop_patience > 0:
                stall = jnp.where(improved, 0, stall + 1)
                done = done | (stall >= stop_patience)
            if stop_frontier > 0:
                unexp2 = ((beam_key3 & 1) == 0) & (beam_d2 < _INF)
                best_unexp = jnp.min(
                    jnp.where(unexp2, beam_d2, _INF), axis=-1
                )
                # Frontier threshold: k-th best (rank 0, the aggressive
                # speed-mode cut) or the frontier_rank-th best — rank=ef is
                # hnswlib's own lower bound (worst of the ef-sized result
                # heap, hnswalg.h:342-436), which loosens as the beam widens
                # and keeps ef a recall lever in the high-recall modes.
                rank = min(frontier_rank, ef) if frontier_rank > 0 else k
                fd = (res_d2 if use_mask else beam_d2)[:, rank - 1]
                done = done | (
                    (best_unexp > stop_frontier * fd) & (fd < _INF)
                )
            if stop_fn is not None:
                view = StopView(
                    beam_d2, beam_key3 >> 1,
                    res_d2 if use_mask else beam_d2, st.it, hops,
                )
                done = done | (stop_fn(view) & active)

        return _BeamState(
            beam_d2, beam_key3, hist2, res_d2, res_id2, hops, dist_comps,
            st.it + 1, kd_prev, stall, done, last_improve,
        )

    init = _BeamState(
        beam_d,
        beam_key,
        hist,
        res_d,
        res_id,
        jnp.zeros((b,), jnp.int32),
        jnp.zeros((b,), jnp.int32),
        jnp.asarray(0, jnp.int32),
        jnp.full((b,), _INF),
        jnp.zeros((b,), jnp.int32),
        jnp.zeros((b,), bool),
        jnp.zeros((b,), jnp.int32),
    )
    final = jax.lax.while_loop(cond, body, init)

    if use_mask:
        out_d, out_i = final.res_d[:, :k], final.res_id[:, :k]
    else:
        out_d, out_i = final.beam_d[:, :k], final.beam_key[:, :k] >> 1
    return SearchResults(
        out_d, out_i, final.hops, final.dist_comps, final.last_improve
    )
