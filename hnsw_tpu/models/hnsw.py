"""HNSWIndex — the user-facing index: host builder + device traversal.

Covers the capability surface of hnswlib::HierarchicalNSW
(hnswlib/hnswalg.h:17-1411): add/update points, delete-mark/unmark, knn query
with per-call ef, filtered query, save/load — with construction on the native
host engine and queries running batched on the accelerator.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

import functools

from hnsw_tpu.core.graph import (
    DeviceGraph,
    HNSWGraph,
    graph_device_arrays,
    pad_vectors,
    round_up,
    upper_host_arrays,
)
from hnsw_tpu.core.spaces import Space, get_space
from hnsw_tpu.ops.traversal import SearchResults, search_batch


def _bucket(k: int) -> int:
    """Round a delta size up to a power-of-two bucket so the jitted
    delta-apply program compiles for O(log) distinct shapes, not one per
    insert size."""
    if k <= 0:
        return 0
    return max(256, 1 << (k - 1).bit_length())


@functools.partial(jax.jit, static_argnames=("has_sq",),
                   donate_argnums=(0, 1, 2))
def _apply_row_deltas(
    x,  # [N_pad, D] vector table (donated)
    sq,  # [N_pad] sq norms or dummy (donated)
    level0,  # [N_pad, m0_pad] (donated)
    new_vecs,  # [Nb, D] appended vectors (zero-padded bucket)
    new_ids,  # [Nb] int32 destination rows (sentinel-padded)
    dirty_ids,  # [Kb] int32 (sentinel-padded bucket)
    dirty_rows,  # [Kb, m0_pad] int32 (sentinel-padded)
    *,
    has_sq: bool,
):
    """Apply insert deltas to the device-resident index in place: append new
    vectors and scatter changed level-0 rows. The padding sentinel row
    (n_pad-1) absorbs bucket-padding writes harmlessly (it stays all-sentinel
    links / zero vectors / zero sq-norm). Replaces a full re-upload on any
    mutation (reference analog: resizeIndex + incremental addPoint,
    hnswalg.h:633-683,954-1267)."""
    if new_vecs.shape[0]:
        x = x.at[new_ids].set(new_vecs.astype(x.dtype))
        if has_sq:
            nsq = jnp.sum(new_vecs.astype(jnp.float32) ** 2, axis=-1)
            sq = sq.at[new_ids].set(nsq)
    if dirty_ids.shape[0]:
        level0 = level0.at[dirty_ids].set(dirty_rows)
    return x, sq, level0


@functools.partial(jax.jit, static_argnames=("k", "m", "space"))
def _rescore_topk(q, x, ids, dists, *, k, m, space):
    """Re-rank the first m beam candidates with exact distances from the
    full-precision vector table, return the best k. The gather runs at
    precision "highest": the hop may round f32 products (TF32 on the GPU),
    and this pass is what restores exact distances and ranks."""
    from hnsw_tpu.ops.distance import gather_dist
    from hnsw_tpu.ops.topk import topk_smallest

    idm = ids[:, :m]
    safe = jnp.clip(idm, 0, x.shape[0] - 1)
    d_ex = gather_dist(q, x, safe, space, precision="highest")
    d_ex = jnp.where(jnp.isfinite(dists[:, :m]), d_ex, jnp.inf)
    dk, pos = topk_smallest(d_ex, k)
    idk = jnp.take_along_axis(idm, pos, axis=-1)
    return dk, idk


def landmark_arrays(dg, x, sq, pool_extra: int = 0):
    """(vectors, ids, sq_norms) of every upper-level node — the graph's own
    1/M sample of the dataset, used as the landmark set of the seeded entry
    mode (SearchParams.entry_seeds). None when the graph has no upper
    levels.

    `pool_extra` > 0 enlarges the pool with that many deterministically
    strided level-0 node ids (evenly spaced over insertion order, skipping
    nodes already in the upper set). The seed matmul's table read amortizes over the whole query batch, so a several-x larger
    pool is nearly free while starting the beam strictly closer — which is
    what shortens the lockstep last-improvement tail that sets batch time.
    """
    if dg.max_level == 0:
        return None
    u_pad = dg.upper.shape[1]
    slot0 = np.asarray(dg.upper_slot[0])
    ids = np.where(slot0 < u_pad - 1)[0].astype(np.int32)
    if not len(ids):
        return None
    if pool_extra > 0:
        n = int(dg.num_nodes)
        mask = np.ones(n, dtype=bool)
        mask[ids[ids < n]] = False
        cand = np.nonzero(mask)[0]
        want = min(pool_extra, len(cand))
        if want > 0:
            sel = cand[
                np.linspace(0, len(cand) - 1, want).astype(np.int64)
            ]
            ids = np.concatenate([ids, sel.astype(np.int32)])
    li = jnp.asarray(ids)
    lv = jnp.take(x, li, axis=0)
    lsq = None if sq is None else jnp.take(sq, li, axis=0)
    return lv, li, lsq


@dataclasses.dataclass
class SearchParams:
    k: int = 10
    ef: int = 200
    expand: int = 1  # beam entries expanded per traversal step
    max_iters: int = 0  # 0 => 2*ef + 16
    collect_metrics: bool = False
    # Adaptive-termination speed mode: stop a query once its top-k has not
    # improved for this many iterations (0 = off; the loop then runs to beam
    # exhaustion, the searchBaseLayerST analog).
    stop_patience: int = 0
    # >0: stop a query once its best unexpanded beam entry is farther than
    # this multiple of its frontier-reference distance (the reference's
    # lower_bound-vs-candidate cut, hnswalg.h:342-436, relaxed by a factor).
    stop_frontier: float = 0.0
    # Beam rank the frontier compares against: 0 => k (the aggressive
    # speed-mode cut), ef => hnswlib's own lower bound (the worst of the
    # ef-sized result heap) — the cut then loosens as the beam widens,
    # keeping ef a recall lever in the high-recall modes.
    frontier_rank: int = 0
    # Exact re-rank of the top-`rescore` candidates against the vector table
    # at full f32 precision (0 or None = off).
    rescore: int | None = None
    # Custom pluggable stop condition (BaseSearchStopCondition analog,
    # hnswlib/hnswlib.h:134-150): StopView -> [B] bool, OR-ed with the
    # patience rule. Must be a hashable (module-level) callable.
    stop_fn: object = None
    # >0: landmark-seeded entry — ONE matmul against all upper-level
    # nodes (the natural 1/M landmark sample) replaces the greedy descent,
    # and the beam starts at the best `entry_seeds` landmarks. The matmul
    # is an EXACT argmin over the landmark set where the descent is
    # approximate, and a multi-seed start shortens the level-0
    # last-improvement tail that sets the lockstep batch time.
    entry_seeds: int = 0
    # >0 (with entry_seeds): add this many strided level-0 nodes to the
    # landmark pool beyond the upper-level set. The seed matmul's cost is
    # amortized over the batch, so a larger pool buys a closer beam start
    # (and thus a lower viable hop budget) almost for free.
    seed_pool: int = 0


class HNSWIndex:
    """Device-resident HNSW index with a native host-side builder."""

    def __init__(
        self,
        space: Space | str,
        dim: int | None = None,
        m: int = 16,
        ef_construction: int = 200,
        seed: int = 123,
        allow_replace_deleted: bool = False,
        growth_headroom: float = 1 / 16,
    ):
        if isinstance(space, str):
            assert dim is not None, "dim required when space given by name"
            space = get_space(space, dim)
        self.space = space
        self.dim = space.dim
        self.m = m
        self.ef_construction = ef_construction
        self.allow_replace_deleted = allow_replace_deleted
        # Device arrays are padded past the current size by this fraction so
        # small inserts apply as row deltas instead of a full re-upload (the
        # resizeIndex analog, hnswalg.h:633-683; amortized like std::vector).
        self.growth_headroom = growth_headroom
        from hnsw_tpu.native.hnsw_builder import NativeHNSWBuilder

        self._builder = NativeHNSWBuilder(
            self.dim, space.name, m, ef_construction, seed
        )
        self._device = None  # (DeviceGraph, vectors, sq_norms, deleted_mask, labels_np)
        self._dirty = True
        self._dirty_deleted = False
        self._synced_n = 0

    # -- construction --------------------------------------------------------

    def add_items(
        self,
        data: np.ndarray,
        labels: np.ndarray | None = None,
        replace_deleted: bool = False,
    ) -> None:
        data = self.space.preprocess(data)
        if labels is None:
            start = self._builder.size
            labels = np.arange(start, start + data.shape[0], dtype=np.int64)
        labels = np.asarray(labels, dtype=np.int64)
        if replace_deleted:
            assert self.allow_replace_deleted, (
                "index built with allow_replace_deleted=False"
            )
            for row, lab in zip(data, labels.reshape(-1)):
                self._builder.add_replace(row, int(lab))
        else:
            self._builder.add_batch(data, labels)
        self._dirty = True

    def add_point(
        self, vec: np.ndarray, label: int, replace_deleted: bool = False
    ) -> None:
        v = self.space.preprocess(vec)[0]
        if replace_deleted:
            assert self.allow_replace_deleted, (
                "index built with allow_replace_deleted=False"
            )
            self._builder.add_replace(v, label)
        else:
            self._builder.add(v, label)
        self._dirty = True

    def mark_deleted(self, label: int) -> None:
        self._builder.mark_deleted(label)
        self._dirty_deleted = True

    def unmark_deleted(self, label: int) -> None:
        self._builder.unmark_deleted(label)
        self._dirty_deleted = True

    @property
    def num_elements(self) -> int:
        return self._builder.size

    @property
    def deleted_count(self) -> int:
        """getDeletedCount analog (hnswalg.h:221-223)."""
        return self._builder.num_deleted

    @property
    def max_elements(self) -> int:
        """getMaxElements analog (hnswalg.h:213-215): allocated slot
        capacity. Unlike hnswlib this index auto-grows past it."""
        return self._builder.capacity

    @property
    def index_file_size(self) -> int:
        """indexFileSize analog (hnswalg.h:658-683): byte size of the
        hnswlib binary save an equivalent index would produce (header +
        per-element level-0 block + upper linklists). This framework's own
        checkpoint is npz (`save`), so this is a capacity-planning figure,
        not the size of `save()` output."""
        return self._builder.index_file_size

    def clear(self) -> None:
        """clear() analog (hnswalg.h:149-161): drop all index content and
        device state, keeping the configuration. Unlike the reference (which
        frees storage for teardown), the index stays usable for new
        inserts."""
        self._builder.clear()
        self._device = None
        self._dirty = True
        self._dirty_deleted = False
        self._synced_n = 0

    def get_items(self, labels) -> np.ndarray:
        """getDataByLabel analog (hnswalg.h:826-851), batched: stored
        vectors for external labels, decoded back to the caller's input
        domain (the shifted-uint8 space un-shifts; normalized spaces return
        the stored normalized form, like the reference returns stored
        bytes). Raises KeyError for an absent or delete-marked label like
        the reference's throws."""
        labs = np.atleast_1d(np.asarray(labels, dtype=np.int64))
        return self.space.decode(np.stack(
            [self._builder.get_data_by_label(int(l)) for l in labs]
        ))

    @property
    def graph(self) -> HNSWGraph:
        return self._builder.export_graph()

    # -- device state --------------------------------------------------------

    def _sync_device(self):
        if self._device is None:
            self._full_sync()
            self._last_sync_mode = "full"
        elif self._dirty:
            if not self._try_incremental_sync():
                self._full_sync()
                self._last_sync_mode = "full"
            else:
                self._refresh_deleted()
                self._last_sync_mode = "delta"
        elif self._dirty_deleted:
            self._refresh_deleted()
            self._last_sync_mode = "deleted"
        else:
            self._last_sync_mode = "clean"
        self._dirty = False
        self._dirty_deleted = False
        return self._device

    def _full_sync(self):
        """Rebuild every device array from the host engine (initial upload,
        growth past the padded capacity, or after an in-place update).

        The previous arrays are released FIRST, so a re-sync after a
        mutation peaks at one copy of the index, not two. Release is by
        refcount: a caller that still holds the returned arrays keeps them
        alive — and pays the 2x peak — by choice."""
        self._device = None
        # the landmark cache keys on the old tuple's identity — after a
        # rebuild it can only miss, and keeping it would pin the old
        # arrays (it holds the tuple) right through the new allocation
        self._landmark_cache = None
        g = self._builder.export_graph()
        n = g.num_nodes
        headroom = int(n * self.growth_headroom)
        n_pad = round_up(n + 1 + headroom, 128)
        dg = graph_device_arrays(g, n_pad)
        x_np = pad_vectors(self._builder.export_vectors(), n_pad)
        x = jnp.asarray(x_np, dtype=self.space.storage_dtype)
        sq = (
            jnp.sum(x.astype(jnp.float32) * x.astype(jnp.float32), axis=-1)
            if self.space.needs_sq_norms
            else None
        )
        deleted = np.zeros(n_pad, dtype=bool)
        deleted[:n] = self._builder.export_deleted().astype(bool)
        labels_np = np.full(n_pad, -1, dtype=np.int64)
        labels_np[:n] = g.labels
        self._device = (dg, x, sq, deleted, labels_np)
        self._builder.clear_dirty()
        self._synced_n = n

    def _refresh_deleted(self):
        """Delete-marks touch no graph or vector state — refresh only the
        host-side eligibility mask (markDelete semantics, hnswalg.h:853-900)."""
        dg, x, sq, _, labels_np = self._device
        deleted = np.zeros(dg.n_pad, dtype=bool)
        n = self._builder.size
        deleted[:n] = self._builder.export_deleted().astype(bool)
        self._device = (dg, x, sq, deleted, labels_np)

    def _try_incremental_sync(self) -> bool:
        """Apply insert AND in-place-update deltas (changed level-0 rows,
        appended/updated vector rows) to the live device arrays; the small
        upper arrays are re-derived wholesale on upper_dirty. Returns False
        only on growth past the padded capacity (reference analog:
        updatePoint repairs locally too, hnswalg.h:995-1150)."""
        b = self._builder
        flags = b.dirty_flags
        if flags & 2:
            return False
        dg, x, sq, deleted, labels_np = self._device
        n_pad = dg.n_pad
        sent = n_pad - 1
        n = b.size
        old_n = self._synced_n
        if n + 1 > n_pad:
            return False
        n_new = n - old_n
        n_upd = b.flush_updates()  # must precede take_dirty
        vec_ids = b.take_vec_dirty(n_upd)
        nb = _bucket(n_new + n_upd)
        dirty_ids = b.take_dirty()
        k = dirty_ids.shape[0]
        if k == 0 and n_new == 0 and n_upd == 0 and not (flags & 1):
            return True
        m0_pad = dg.level0.shape[1]
        rows = b.export_level0_rows(dirty_ids)
        rows = np.where(rows < 0, sent, rows).astype(np.int32)
        if rows.shape[1] != m0_pad:
            rows = np.concatenate(
                [rows, np.full((k, m0_pad - rows.shape[1]), sent, np.int32)],
                axis=1,
            )
        kb = _bucket(k)
        if kb != k:
            dirty_ids = np.concatenate(
                [dirty_ids, np.full(kb - k, sent, np.int32)]
            )
            rows = np.concatenate(
                [rows, np.full((kb - k, m0_pad), sent, np.int32)]
            )
        new_vecs = np.zeros((nb, self.dim), np.float32)
        new_ids = np.full(nb, sent, np.int32)
        if n_new:
            new_vecs[:n_new] = b.export_vectors_range(old_n, n_new)
            new_ids[:n_new] = np.arange(old_n, n, dtype=np.int32)
        if n_upd:
            # in-place updates ride the same scatter as appended rows
            new_vecs[n_new : n_new + n_upd] = b.export_vectors_rows(vec_ids)
            new_ids[n_new : n_new + n_upd] = vec_ids

        sq_in = sq if sq is not None else jnp.zeros((1,), jnp.float32)
        x, sq_in, level0 = _apply_row_deltas(
            x,
            sq_in,
            dg.level0,
            jnp.asarray(new_vecs),
            jnp.asarray(new_ids),
            jnp.asarray(dirty_ids.astype(np.int32)),
            jnp.asarray(rows),
            has_sq=sq is not None,
        )
        sq = sq_in if sq is not None else None

        labels_changed = n_new > 0
        if n_new:
            labels_np = labels_np.copy()
            labels_np[old_n:n] = b.export_labels_range(old_n, n_new)
        if n_upd:
            # a replace_deleted reuse changes the label at the updated slot
            for i in vec_ids:
                lab = b.export_labels_range(int(i), 1)[0]
                if labels_np[i] != lab:
                    if not labels_changed:
                        labels_np = labels_np.copy()
                        labels_changed = True
                    labels_np[i] = lab
        rep = {"level0": level0, "num_nodes": jnp.asarray(n, jnp.int32)}
        if flags & 1:
            # upper levels / entry changed: re-derive the (small) upper
            # arrays wholesale
            g = b.export_graph()
            upper, upper_slot = upper_host_arrays(g, n_pad)
            rep.update(
                upper=jnp.asarray(upper),
                upper_slot=jnp.asarray(upper_slot),
                entry_point=jnp.asarray(g.entry_point, jnp.int32),
            )
        if labels_changed:
            lab_dev = np.full(n_pad, -1, dtype=np.int64)
            lab_dev[:n] = labels_np[:n]
            rep["labels"] = jnp.asarray(lab_dev)
        dg = dataclasses.replace(dg, **rep)
        self._device = (dg, x, sq, deleted, labels_np)
        self._landmark_cache = None  # identity-keyed: stale, and it pins
        self._synced_n = n           # pre-delta array versions
        return True

    @property
    def device_graph(self) -> DeviceGraph:
        return self._sync_device()[0]

    @property
    def device_vectors(self) -> jax.Array:
        return self._sync_device()[1]

    @property
    def device_sq_norms(self) -> jax.Array | None:
        return self._sync_device()[2]

    # -- search ---------------------------------------------------------------

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        ef: int = 200,
        *,
        filter_labels: np.ndarray | None = None,
        entry_ids: np.ndarray | None = None,
        entry_seeds: int = 0,
        seed_pool: int = 0,
        params: SearchParams | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched kNN → (dists [B, k], labels [B, k]; label -1 = missing).

        Rows are ascending by distance — searchKnnCloserFirst semantics
        (hnswlib/hnswlib.h:197-201, which reverses searchKnn's max-heap
        order) are the native output order here, no reversal needed.

        `filter_labels`: bool mask over external labels (BaseFilterFunctor
        semantics, hnswlib/hnswlib.h:128-132) — either one shared [L] mask
        for the whole batch, or a per-query [B, L] mask (the reference's
        functor is evaluated per query; per-tenant serving filters need a
        different allowlist per row). Deleted elements are always excluded
        from results (markDelete semantics, hnswalg.h:853-900).

        `entry_seeds` / `seed_pool`: landmark-seeded entry — shorthand for
        `SearchParams(entry_seeds=, seed_pool=)` when no explicit `params`
        is given.
        """
        if params is None:
            params = SearchParams(k=k, ef=max(ef, k),
                                  entry_seeds=entry_seeds,
                                  seed_pool=seed_pool)
        dg, x, sq, deleted, labels_np = self._sync_device()
        q_np = self.space.preprocess(queries)
        b0 = q_np.shape[0]
        # batches pad to a multiple of 16: nearby sizes share one program
        b_pad = ((b0 + 15) // 16) * 16
        if b_pad != b0:
            q_np = np.concatenate(
                [q_np, np.zeros((b_pad - b0, self.dim), np.float32)]
            )
        q = jnp.asarray(q_np)

        eligible = None
        if deleted.any() or filter_labels is not None:
            eligible = ~deleted
            if filter_labels is not None:
                fl = np.asarray(filter_labels, dtype=bool)
                valid = labels_np >= 0
                if fl.ndim == 2:
                    # per-query masks: expand label-space rows to node-space
                    # [B, N_pad] (padded queries get all-False rows — their
                    # results are discarded anyway)
                    assert fl.shape[0] == b0, (
                        f"filter_labels rows {fl.shape[0]} != batch {b0}"
                    )
                    ok = np.zeros((b_pad, eligible.shape[0]), dtype=bool)
                    ok[:b0, valid] = fl[:, labels_np[valid]]
                    eligible = eligible[None, :] & ok
                else:
                    ok = np.zeros_like(eligible)
                    ok[valid] = fl[labels_np[valid]]
                    eligible = eligible & ok
            eligible = jnp.asarray(eligible)

        m_res = min(params.rescore or 0, params.ef)
        # the rescore re-ranks the top m_res beam candidates, so the search
        # must RETURN that many — asking for k and rescoring "the top 4k"
        # would silently re-rank only k candidates
        k_search = max(params.k, m_res) if m_res >= params.k else params.k
        seed_kwargs = {}
        if params.entry_seeds > 0 and entry_ids is None and dg.max_level > 0:
            lm = self._landmark_arrays(dg, x, sq,
                                       pool_extra=params.seed_pool)
            if lm is not None:
                from hnsw_tpu.ops.topk import bruteforce_topk

                lv, li, lsq = lm
                s = min(params.entry_seeds, int(li.shape[0]),
                        max(params.ef, k_search))
                sd, si = bruteforce_topk(
                    q, lv, s, self.space.name, x_sq_norms=lsq
                )
                seed_kwargs = {
                    "seed_ids": jnp.take(li, si, axis=0),
                    "seed_dists": sd,
                }
        res = search_batch(
            x,
            dg,
            q,
            k=k_search,
            ef=max(params.ef, k_search),
            space=self.space.name,
            sq_norms=sq,
            eligible=eligible,
            entry_ids=None
            if entry_ids is None
            else jnp.asarray(
                np.concatenate(
                    [np.asarray(entry_ids), np.zeros(b_pad - b0, np.int32)]
                ).astype(np.int32)
            ),
            expand=params.expand,
            max_iters=params.max_iters,
            collect_metrics=params.collect_metrics,
            has_mask=eligible is not None,
            stop_patience=params.stop_patience,
            stop_frontier=params.stop_frontier,
            frontier_rank=params.frontier_rank,
            stop_fn=params.stop_fn,
            **seed_kwargs,
        )
        if m_res >= params.k and m_res > 0:
            rd, ri = _rescore_topk(
                q,
                x,
                res.ids,
                res.dists,
                k=params.k,
                m=m_res,
                space=self.space.name,
            )
            res = SearchResults(
                rd, ri, res.hops, res.dist_comps, res.last_improve
            )
        dists = np.asarray(res.dists)[:b0]
        ids = np.asarray(res.ids)[:b0]
        labels = np.where(ids < len(labels_np), labels_np[np.minimum(ids, len(labels_np) - 1)], -1)
        labels = np.where(np.isfinite(dists), labels, -1)
        self.last_metrics = SearchResults(
            res.dists[:b0],
            res.ids[:b0],
            np.asarray(res.hops)[:b0],
            np.asarray(res.dist_comps)[:b0],
            None
            if res.last_improve is None
            else np.asarray(res.last_improve)[:b0],
        )
        return dists, labels

    def _landmark_arrays(self, dg, x, sq, pool_extra: int = 0):
        """Device arrays for the landmark-seeded entry mode
        (SearchParams.entry_seeds), cached per (device-sync generation,
        pool_extra) — any row delta or full sync replaces self._device,
        invalidating the cache."""
        cache = getattr(self, "_landmark_cache", None)
        if (cache is not None and cache[0] is self._device
                and cache[1] == pool_extra):
            return cache[2]
        lm = landmark_arrays(dg, x, sq, pool_extra=pool_extra)
        self._landmark_cache = (self._device, pool_extra, lm)
        return lm

    def calibrate_speed_mode(
        self,
        queries: np.ndarray | None = None,
        *,
        k: int = 10,
        ef: int = 200,
        expand: int = 2,
        stop_frontier: float = 1.15,
        percentile: float = 99.9,
        margin: int = 2,
        sample: int = 2048,
        seed: int = 0,
        entry_seeds: int = 0,
        seed_pool: int = 0,
    ) -> SearchParams:
        """Auto-tune the adaptive-termination speed mode for THIS index and
        operating point, returning a ready `SearchParams` (also stored as
        `self.speed_params`).

        The batch traverses in lockstep, so batch time equals the slowest
        query's iteration count; the frontier stop (the reference's
        lower_bound-vs-candidate cut, hnswalg.h:342-436, relaxed by
        `stop_frontier`) leaves a straggler max-hop tail well past its p99.
        Late iterations almost never improve the top-k, so the budget is
        set from the tail of the LAST-IMPROVEMENT distribution — the last
        iteration at which each query's k-th best distance decreased — at
        `percentile` plus `margin` iterations of slack.

        `queries`: calibration batch; defaults to `sample` perturbed stored
        vectors (self-queries, the reference methodology,
        bin/experiment.py:160-234)."""
        if queries is None:
            n = self.num_elements
            rng = np.random.default_rng(seed)
            rows = rng.integers(0, n, size=min(sample, n))
            base = self._builder.export_vectors_rows(
                rows.astype(np.int64)
            ).astype(np.float32)
            queries = base + 0.05 * rng.standard_normal(
                base.shape
            ).astype(np.float32)
        probe = SearchParams(
            k=k, ef=max(ef, k), expand=expand,
            stop_frontier=stop_frontier, collect_metrics=True,
            entry_seeds=entry_seeds, seed_pool=seed_pool,
        )
        self.search(queries, params=probe)
        last = np.asarray(self.last_metrics.last_improve)
        cap = int(np.percentile(last, percentile)) + int(margin)
        cap = max(cap, 1)
        default_cap = 2 * max(ef, k) + 16
        if cap >= default_cap:
            cap = 0  # budget would never bind; leave uncapped
        self.speed_params = SearchParams(
            k=k, ef=max(ef, k), expand=expand,
            stop_frontier=stop_frontier, max_iters=cap,
            entry_seeds=entry_seeds, seed_pool=seed_pool,
        )
        return self.speed_params

    def search_cpu(
        self,
        queries: np.ndarray,
        k: int = 10,
        ef: int = 200,
        *,
        filter_labels: np.ndarray | None = None,
    ):
        """Single-core native CPU search (baseline parity path).

        `filter_labels` mirrors the device path's BaseFilterFunctor mask
        (hnswlib/hnswlib.h:128-132, hnswalg.h:1271): a bool mask over
        external labels — [L] shared, or [B, L] per query — so filtered
        device queries have a CPU oracle."""
        q = self.space.preprocess(queries)
        if filter_labels is not None:
            fl = np.asarray(filter_labels, dtype=bool)
            labs = self._builder.export_graph().labels
            if fl.ndim == 2:
                # per-query functor semantics: one filtered search per row
                assert fl.shape[0] == q.shape[0]
                parts = [
                    self._builder.search_batch(
                        q[i : i + 1], k, ef, eligible=fl[i][labs]
                    )
                    for i in range(q.shape[0])
                ]
                return tuple(np.concatenate(p) for p in zip(*parts))
            return self._builder.search_batch(q, k, ef, eligible=fl[labs])
        return self._builder.search_batch(q, k, ef, eligible=None)

    # -- persistence (reference: saveIndex/loadIndex hnswalg.h:685-822 and
    # the .adj export, index_builder/build.cpp:22-107) ----------------------

    def save(self, path: str, compress: bool = True) -> None:
        from hnsw_tpu.io.checkpoint import save_checkpoint

        save_checkpoint(
            path,
            self._builder.export_graph(),
            self._builder.export_vectors(),
            self._builder.export_deleted(),
            compress=compress,
            meta={
                "space": self.space.persist_name,
                "dim": self.dim,
                "m": self.m,
                "ef_construction": self.ef_construction,
                "allow_replace_deleted": self.allow_replace_deleted,
            },
        )

    @classmethod
    def load(cls, path: str) -> "HNSWIndex":
        from hnsw_tpu.io.checkpoint import load_checkpoint

        return cls._from_parts(*load_checkpoint(path))

    @classmethod
    def _from_parts(cls, g, vectors, deleted, meta) -> "HNSWIndex":
        """Construct a live index from (graph, internal vectors, deleted
        mask, meta) — the shared tail of every persistence loader."""
        from hnsw_tpu.native.hnsw_builder import NativeHNSWBuilder

        self = cls.__new__(cls)
        self.space = get_space(meta["space"], meta["dim"])
        self.dim = meta["dim"]
        self.m = meta["m"]
        self.ef_construction = meta["ef_construction"]
        self._builder = NativeHNSWBuilder.from_graph(
            g, vectors, deleted, space=self.space.name,
            ef_construction=meta["ef_construction"],
        )
        self._device = None
        self._dirty = True
        self._dirty_deleted = False
        self._synced_n = 0
        self.allow_replace_deleted = bool(meta.get("allow_replace_deleted", False))
        self.growth_headroom = 1 / 16
        return self

    @classmethod
    def from_hnswlib(cls, path: str, space: str = "l2") -> "HNSWIndex":
        """Import a stock hnswlib binary index file (the saveIndex format,
        hnswlib/hnswalg.h:685-822) — graph topology, vectors, labels and
        delete marks — into a live device index. `space` is the space the file
        was built over: 'l2' / 'ip' / 'cosine' (f32 data) or 'l2u8' (the
        integer L2SpaceI layout). Validated against index files the actual
        compiled reference engine saves (tests/test_hnswlib_bin.py)."""
        from hnsw_tpu.io.hnswbin import read_bin

        g, vectors, deleted, meta = read_bin(path, space=space)
        sp = get_space(space, meta["dim"])
        # file vectors are raw inserted values; internal storage is the
        # space's preprocessed form (shift for l2u8, normalize for cosine —
        # idempotent on already-normalized rows)
        internal = sp.preprocess(vectors) if g.num_nodes else np.zeros(
            (0, meta["dim"]), np.float32
        )
        return cls._from_parts(
            g, internal, deleted,
            {"space": space, "dim": meta["dim"], "m": meta["m"],
             "ef_construction": meta["ef_construction"]},
        )

    def save_hnswlib(self, path: str) -> None:
        """Export to the stock hnswlib saveIndex format, loadable by the
        reference engine's loadIndex (round-tripped through the actual
        compiled engine in tests/test_hnswlib_bin.py). 'l2'/'ip' write f32
        data for L2Space/InnerProductSpace, 'cosine' writes the normalized
        rows (load over InnerProductSpace), 'l2u8' writes u8 codes for
        L2SpaceI."""
        from hnsw_tpu.io.hnswbin import write_bin

        vectors = self._builder.export_vectors()
        name = self.space.persist_name
        if name == "l2u8":
            vectors = self.space.decode(vectors)  # back to u8-range codes
        write_bin(
            path, self._builder.export_graph(), vectors,
            self._builder.export_deleted(), space=name, m=self.m,
            ef_construction=self.ef_construction,
        )

    def export_adj(self, path: str) -> None:
        """Write the reference-compatible adjacency file
        (format: index_builder/build.cpp:14-21) — native streaming writer."""
        self._builder.export_adj(path)
