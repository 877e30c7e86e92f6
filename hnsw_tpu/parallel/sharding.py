"""Multi-device sharded HNSW search.

The reference's only "distribution" is an HTTP storage/compute split on
localhost (SURVEY.md §2: no collectives of any kind; per-vector HTTP GETs,
hnsw_service/hnsw_graph.cpp:174-212). The device-native replacement follows
BASELINE.json config 4: the dataset is partitioned into one complete HNSW
sub-index per device, all device arrays are stacked [S, ...] and sharded over
a mesh axis, queries are replicated; each device runs the batched beam
traversal on its local shard inside `shard_map`, and per-shard top-k results
are merged with one `all_gather` — the XLA-collective equivalent of the
reference's per-node network fetches. The search exchanges only the [S, B, k]
partial results, so the mesh is a flat "shard" axis over however the devices
are linked.

A second mesh axis ("dp") shards the query batch — the data-parallel axis —
so a (dp, shard) 2D mesh scales both index size and query throughput.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hnsw_tpu.core.graph import (
    DeviceGraph,
    graph_device_arrays,
    pad_vectors,
    round_up,
)
from hnsw_tpu.core.spaces import Space, get_space
from hnsw_tpu.ops.topk import topk_smallest
from hnsw_tpu.ops.traversal import search_batch


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedIndexArrays:
    """Stacked per-shard device arrays; leading axis S is sharded."""

    vectors: jax.Array  # [S, n_pad, D]
    sq_norms: jax.Array  # [S, n_pad] (zeros for ip space)
    level0: jax.Array  # [S, n_pad, maxM0]
    upper: jax.Array  # [S, L, U_pad, M]
    upper_slot: jax.Array  # [S, L, n_pad]
    labels: jax.Array  # [S, n_pad] int64 (-1 padding)
    entry_point: jax.Array  # [S] int32
    num_nodes: jax.Array  # [S] int32


def _local_graph(a: ShardedIndexArrays) -> DeviceGraph:
    """View the (already shard-local, leading dim stripped) arrays as a
    DeviceGraph for search_batch."""
    return DeviceGraph(
        level0=a.level0,
        upper=a.upper,
        upper_slot=a.upper_slot,
        labels=a.labels,
        entry_point=a.entry_point,
        num_nodes=a.num_nodes,
    )


def build_sharded_arrays(
    shards: list[tuple["HNSWGraph", np.ndarray]],
    space: Space,
    mesh: Mesh,
    shard_axis: str = "shard",
    growth_headroom: float = 1 / 16,
) -> ShardedIndexArrays:
    """Stack per-shard (graph, vectors) into uniform [S, ...] arrays and
    place them sharded over `mesh[shard_axis]`. Pads every shard to common
    n_pad / max_level / upper width so shapes are static, with growth
    headroom so small inserts re-stack as row deltas (the single-chip
    resizeIndex analog, hnswalg.h:633-683)."""
    s = len(shards)
    n_max = max(g.num_nodes for g, _ in shards)
    n_pad = round_up(n_max + 1 + int(n_max * growth_headroom), 128)
    max_l = max(g.max_level for g, _ in shards)
    dim = shards[0][1].shape[1]
    max_m0 = max(g.max_m0 for g, _ in shards)

    dgs = []
    for g, _ in shards:
        assert g.max_m0 == max_m0, "shards must share maxM0"
        dgs.append(graph_device_arrays(g, n_pad))

    m0_pad = dgs[0].level0.shape[1]  # link width after 16-alignment
    max_m = max((dg.upper.shape[2] for dg in dgs if dg.max_level > 0), default=1)
    u_pad = max((dg.upper.shape[1] for dg in dgs if dg.max_level > 0), default=1)

    level0 = np.full((s, n_pad, m0_pad), n_pad - 1, dtype=np.int32)
    upper = np.full((s, max_l, u_pad, max_m), n_pad - 1, dtype=np.int32)
    upper_slot = np.full((s, max_l, n_pad), u_pad - 1, dtype=np.int32)
    labels = np.full((s, n_pad), -1, dtype=np.int64)
    entry = np.zeros(s, dtype=np.int32)
    nn = np.zeros(s, dtype=np.int32)
    vecs = np.zeros((s, n_pad, dim), dtype=np.float32)

    for i, ((g, x), dg) in enumerate(zip(shards, dgs)):
        level0[i] = np.asarray(dg.level0)
        l_i = dg.max_level
        if l_i > 0:
            u_i = dg.upper.shape[1]
            m_i = dg.upper.shape[2]
            upper[i, :l_i, :u_i, :m_i] = np.asarray(dg.upper)
            # remap the shard's own dummy slot (u_i-1, from its per-shard
            # padding) to the STACKED dummy u_pad-1, so every shard marks
            # "absent at this level" with the same slot
            us = np.asarray(dg.upper_slot)
            upper_slot[i, :l_i] = np.where(us == u_i - 1, u_pad - 1, us)
        labels[i] = np.asarray(dg.labels)
        entry[i] = int(dg.entry_point)
        nn[i] = int(dg.num_nodes)
        vecs[i] = pad_vectors(x, n_pad)

    sq = (vecs.astype(np.float64) ** 2).sum(-1).astype(np.float32)

    shard_spec = lambda *rest: NamedSharding(mesh, P(shard_axis, *rest))
    put = lambda a, spec: jax.device_put(jnp.asarray(a), spec)
    vecs_dev = put(vecs, shard_spec(None, None))
    if space.storage_dtype != jnp.float32:
        vecs_dev = jax.jit(
            lambda v: v.astype(space.storage_dtype),
            donate_argnums=0,
            out_shardings=shard_spec(None, None),
        )(vecs_dev)
    level0_dev = put(level0, shard_spec(None, None))
    upper_dev = put(upper, shard_spec(None, None, None))
    upper_slot_dev = put(upper_slot, shard_spec(None, None))

    return ShardedIndexArrays(
        vectors=vecs_dev,
        sq_norms=put(sq, shard_spec(None)),
        level0=level0_dev,
        upper=upper_dev,
        upper_slot=upper_slot_dev,
        labels=put(labels, shard_spec(None)),
        entry_point=put(entry, shard_spec()),
        num_nodes=put(nn, shard_spec()),
    )


def sharded_landmark_arrays(
    arrays: ShardedIndexArrays,
    mesh: Mesh,
    shard_axis: str = "shard",
    pool_extra: int = 0,
):
    """Stacked per-shard landmark arrays (vectors [S, L_pad, D],
    local ids [S, L_pad] int32 with -1 padding, sq_norms [S, L_pad]) for
    the landmark-seeded entry mode — the sharded mirror of
    models.hnsw.landmark_arrays. Each shard's landmark set is its own
    upper-level nodes; shards are padded to a common L_pad with id -1 and
    a huge sq_norm so padded rows sort last in the l2 seed matmul (ip
    padding is masked post-topk inside sharded_search). Returns None when
    no shard has upper levels.

    `pool_extra` > 0 enlarges each shard's pool with that many strided
    level-0 node ids (SearchParams.seed_pool parity)."""
    if arrays.upper_slot.shape[1] == 0:
        return None
    u_pad = arrays.upper.shape[2]
    slot0 = np.asarray(arrays.upper_slot[:, 0, :])  # [S, n_pad]
    per = [np.where(row < u_pad - 1)[0].astype(np.int32) for row in slot0]
    if pool_extra > 0:
        nn = np.asarray(arrays.num_nodes)
        for i, p in enumerate(per):
            mask = np.ones(int(nn[i]), dtype=bool)
            mask[p[p < int(nn[i])]] = False
            cand = np.nonzero(mask)[0]
            want = min(pool_extra, len(cand))
            if want > 0:
                sel = cand[
                    np.linspace(0, len(cand) - 1, want).astype(np.int64)
                ]
                per[i] = np.concatenate([p, sel.astype(np.int32)])
    l_max = max((len(p) for p in per), default=0)
    if l_max == 0:
        return None
    s = len(per)
    l_pad = round_up(l_max, 128)
    ids = np.full((s, l_pad), -1, dtype=np.int32)
    for i, p in enumerate(per):
        ids[i, : len(p)] = p
    spec2 = NamedSharding(mesh, P(shard_axis, None))
    spec3 = NamedSharding(mesh, P(shard_axis, None, None))
    li = jax.device_put(jnp.asarray(ids), spec2)
    safe = jnp.maximum(li, 0)
    lv = jax.jit(
        jax.vmap(lambda x1, i1: jnp.take(x1, i1, axis=0)),
        out_shardings=spec3,
    )(arrays.vectors, safe)
    lsq = jax.jit(
        jax.vmap(
            lambda sq1, i1, ok: jnp.where(ok, jnp.take(sq1, i1), 1e30)
        ),
        out_shardings=spec2,
    )(arrays.sq_norms, safe, li >= 0)
    return lv, li, lsq


@functools.partial(
    jax.jit,
    static_argnames=(
        "k", "ef", "space", "expand", "max_iters", "mesh", "dp_axis",
        "shard_axis", "has_mask", "has_entry", "stop_patience",
        "stop_frontier", "frontier_rank", "entry_seeds", "stop_fn",
    ),
)
def sharded_search(
    arrays: ShardedIndexArrays,
    queries: jax.Array,  # [B, D], replicated (or dp-sharded) across devices
    eligible: jax.Array,  # [S, n_pad] bool per-shard mask, or [S, B, n_pad]
    #   per-query masks ([S, 1] dummy when off)
    entry_ids: jax.Array,  # [S, B] int32 per-shard entry override ([S, 1] dummy)
    landmarks=None,  # (lv [S,L,D], li [S,L], lsq [S,L]) per-shard landmark
    #   set from sharded_landmark_arrays, or None (required if entry_seeds>0)
    *,
    k: int,
    ef: int,
    space: str = "l2",
    expand: int = 1,
    max_iters: int = 0,
    mesh: Mesh,
    dp_axis: str | None = None,
    shard_axis: str = "shard",
    has_mask: bool = False,
    has_entry: bool = False,
    stop_patience: int = 0,
    stop_frontier: float = 0.0,
    frontier_rank: int = 0,
    entry_seeds: int = 0,
    stop_fn: object = None,
) -> tuple[jax.Array, jax.Array]:
    """Search all shards and merge → (dists [B, k], labels [B, k] int64).

    Inside shard_map each device searches its own sub-index with the full
    single-chip kernel; the [S, B, k] partial results are all-gathered and
    reduced by a length-S*k top-k merge, replicated back.

    `eligible` carries deleted-mark + label-filter eligibility per shard
    (markDelete/BaseFilterFunctor parity with the single-chip index,
    hnswalg.h:853-900, hnswlib.h:128-132); `entry_ids` carries per-shard
    local entry overrides (-1 = that shard's default entry point).

    `entry_seeds` > 0 enables the landmark-seeded entry mode per shard
    (SearchParams.entry_seeds parity): each device runs one matmul of
    its dp-local queries against its own upper-level nodes and starts the
    beam at the best S landmarks instead of the greedy descent. The seed
    matmul is shard-local, so the mode composes with the shard merge at no
    collective cost. Ignored when a per-query entry override is given.
    """
    q_spec = P(dp_axis, None) if dp_axis else P()
    # every index leaf is sharded on its leading [S] axis
    arr_spec = ShardedIndexArrays(
        vectors=P(shard_axis, None, None),
        sq_norms=P(shard_axis, None),
        level0=P(shard_axis, None, None),
        upper=P(shard_axis, None, None, None),
        upper_slot=P(shard_axis, None, None),
        labels=P(shard_axis, None),
        entry_point=P(shard_axis),
        num_nodes=P(shard_axis),
    )
    out_spec = (q_spec, q_spec) if dp_axis else (P(), P())
    # per-query masks carry a batch axis that must follow the dp split
    if eligible.ndim == 3:
        elig_spec = P(shard_axis, dp_axis, None) if dp_axis else P(
            shard_axis, None, None
        )
    else:
        elig_spec = P(shard_axis, None)
    # the dummy entry array is [S, 1] — only dp-split a real [S, B] one
    ent_spec = (
        P(shard_axis, dp_axis) if (dp_axis and has_entry) else P(shard_axis, None)
    )

    use_seeds = entry_seeds > 0 and landmarks is not None and not has_entry
    lm_spec = (
        (P(shard_axis, None, None), P(shard_axis, None), P(shard_axis, None))
        if use_seeds
        else None
    )

    def local(
        a: ShardedIndexArrays, q: jax.Array, el: jax.Array, en: jax.Array, lm
    ):
        # strip the leading local-shard dim (size 1 per device)
        a1 = jax.tree_util.tree_map(lambda t: t[0], a)
        seed_kwargs = {}
        if use_seeds:
            # landmark-seeded entry, shard-locally: one matmul of the
            # dp-local queries against this shard's upper-level nodes;
            # padded landmark rows (id -1) are forced to inf so they never
            # displace the descent-quality entry (traversal.py seed init
            # drops inf seeds to empty beam slots)
            from hnsw_tpu.ops.topk import bruteforce_topk

            lv, li, lsq = lm[0][0], lm[1][0], lm[2][0]
            s_seeds = min(entry_seeds, int(li.shape[0]), ef)
            sd, si = bruteforce_topk(
                q, lv, s_seeds, space,
                x_sq_norms=lsq if space == "l2" else None,
            )
            sid = jnp.take(li, si, axis=0)
            seed_kwargs = {
                "seed_ids": sid,
                "seed_dists": jnp.where(sid >= 0, sd, jnp.inf),
            }
        res = search_batch(
            a1.vectors,
            _local_graph(a1),
            q,
            k=k,
            ef=max(ef, k),
            space=space,
            sq_norms=a1.sq_norms if space == "l2" else None,
            eligible=el[0] if has_mask else None,
            has_mask=has_mask,
            entry_ids=en[0] if has_entry else None,
            **seed_kwargs,
            expand=expand,
            max_iters=max_iters,
            stop_patience=stop_patience,
            stop_frontier=stop_frontier,
            frontier_rank=frontier_rank,
            stop_fn=stop_fn,
        )
        # local ids -> global labels before leaving the shard
        lab = jnp.take(a1.labels, jnp.clip(res.ids, 0, a1.labels.shape[0] - 1))
        lab = jnp.where(jnp.isfinite(res.dists), lab, -1)
        # all-gather partials, merge top-k (replicated result)
        all_d = jax.lax.all_gather(res.dists, shard_axis)  # [S, B, k]
        all_l = jax.lax.all_gather(lab, shard_axis)  # [S, B, k]
        s = all_d.shape[0]
        b = all_d.shape[1]
        flat_d = jnp.moveaxis(all_d, 0, 1).reshape(b, s * k)
        flat_l = jnp.moveaxis(all_l, 0, 1).reshape(b, s * k)
        dk, pos = topk_smallest(flat_d, k)
        lk = jnp.take_along_axis(flat_l, pos, axis=-1)
        return dk, lk

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(arr_spec, q_spec, elig_spec, ent_spec, lm_spec),
        out_specs=out_spec,
        check_vma=False,
    )
    return fn(arrays, queries, eligible, entry_ids,
              landmarks if use_seeds else None)


def _bucket(k: int) -> int:
    """Power-of-two delta buckets: O(log) compiled delta programs."""
    if k <= 0:
        return 0
    return max(256, 1 << (k - 1).bit_length())


@functools.partial(
    jax.jit, static_argnames=("has_sq",), donate_argnums=(0, 1, 2, 3, 4)
)
def _apply_sharded_row_deltas(
    x,  # [S, n_pad, D] (donated)
    sq,  # [S, n_pad] or [1] dummy (donated)
    level0,  # [S, n_pad, m0_pad] (donated)
    labels,  # [S, n_pad] int64 (donated)
    num_nodes,  # [S] int32 (donated)
    new_vecs,  # [S, Nb, D]
    new_ids,  # [S, Nb] int32 (sent-padded)
    new_labs,  # [S, Nb] int64
    dirty_ids,  # [S, Kb] int32 (sent-padded)
    dirty_rows,  # [S, Kb, m0_pad] int32
    new_nn,  # [S] int32
    *,
    has_sq: bool,
):
    """Sharded mirror of models.hnsw._apply_row_deltas, vmapped over the
    shard axis: every device applies its own shard's insert/update delta in
    place instead of a full re-stack."""
    sent = level0.shape[1] - 1

    def one(x1, sq1, l01, lab1, nvecs, nids, nlabs, dids, drows):
        if nvecs.shape[0]:
            x1 = x1.at[nids].set(nvecs.astype(x1.dtype))
            lab1 = lab1.at[nids].set(nlabs)
            # padding writes hit the sentinel row; restore its -1 label
            lab1 = lab1.at[sent].set(-1)
            if has_sq:
                nsq = jnp.sum(nvecs.astype(jnp.float32) ** 2, axis=-1)
                sq1 = sq1.at[nids].set(nsq)
        if dids.shape[0]:
            l01 = l01.at[dids].set(drows)
        return x1, sq1, l01, lab1

    sq_in = sq if has_sq else jnp.zeros((x.shape[0], 1), jnp.float32)
    x, sq_out, level0, labels = jax.vmap(one)(
        x, sq_in, level0, labels, new_vecs, new_ids, new_labs, dirty_ids,
        dirty_rows,
    )
    return x, sq_out if has_sq else sq, level0, labels, new_nn


class ShardedHNSWIndex:
    """Dataset partitioned into one HNSW sub-index per mesh shard.

    Build runs one native builder per shard in a thread pool (the C ABI
    releases the GIL, so shard builds use all host cores — the reference's
    build loop is strictly serial, index_builder/build.cpp:137-145).
    """

    def __init__(
        self,
        space: Space | str,
        dim: int | None = None,
        *,
        mesh: Mesh,
        shard_axis: str = "shard",
        dp_axis: str | None = None,
        m: int = 16,
        ef_construction: int = 200,
        seed: int = 123,
    ):
        if isinstance(space, str):
            space = get_space(space, dim)
        self.space = space
        self.dim = space.dim
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.dp_axis = dp_axis
        self.num_shards = mesh.shape[shard_axis]
        self.m = m
        self.ef_construction = ef_construction
        self.seed = seed
        self._builders = None
        self._shard_labels: list[np.ndarray] | None = None  # per-shard labels
        self._shard_deleted: list[np.ndarray] | None = None  # per-shard bool
        self._label_map: dict[int, tuple[int, int]] | None = None  # label -> (shard, local)
        self._arrays: ShardedIndexArrays | None = None
        self._synced_n: list[int] | None = None  # per-shard device-synced size
        self._pending_delta = False
        self.last_sync_mode: str | None = None

    def build(self, data: np.ndarray, labels: np.ndarray | None = None) -> None:
        from hnsw_tpu.native.hnsw_builder import NativeHNSWBuilder

        data = self.space.preprocess(data)
        n = data.shape[0]
        if labels is None:
            labels = np.arange(n, dtype=np.int64)
        labels = np.asarray(labels, dtype=np.int64)
        s = self.num_shards
        # round-robin partition keeps shards balanced for any input order
        parts = [np.arange(i, n, s) for i in range(s)]

        def build_one(i):
            b = NativeHNSWBuilder(
                self.dim, self.space.name, self.m, self.ef_construction,
                self.seed + i,
            )
            b.add_batch(data[parts[i]], labels[parts[i]])
            return b

        with concurrent.futures.ThreadPoolExecutor(max_workers=s) as ex:
            self._builders = list(ex.map(build_one, range(s)))
        self._reindex_labels()
        self._rebuild_arrays()

    def _reindex_labels(self) -> None:
        """Rebuild the per-shard label tables and the label -> (shard, local)
        map from the builders (single-chip feature parity: filters, deletes
        and entry overrides address elements by external label)."""
        self._shard_labels = []
        self._shard_deleted = []
        self._label_map = {}
        for i, b in enumerate(self._builders):
            g = b.export_graph()
            self._shard_labels.append(g.labels.copy())
            self._shard_deleted.append(b.export_deleted().astype(bool))
            for local, lab in enumerate(g.labels):
                self._label_map[int(lab)] = (i, local)

    def _rebuild_arrays(self) -> None:
        shards = [
            (b.export_graph(), b.export_vectors()) for b in self._builders
        ]
        self._arrays = build_sharded_arrays(
            shards, self.space, self.mesh, self.shard_axis,
        )
        for b in self._builders:
            b.clear_dirty()
        self._synced_n = [b.size for b in self._builders]
        self._pending_delta = False
        self.last_sync_mode = "full"

    @property
    def arrays(self) -> ShardedIndexArrays:
        assert self._builders is not None, "call build() first"
        if self._arrays is None:
            self._rebuild_arrays()
        elif self._pending_delta:
            if self._try_shard_deltas():
                self.last_sync_mode = "delta"
                self._pending_delta = False
            else:
                self._rebuild_arrays()
        return self._arrays

    def _try_shard_deltas(self) -> bool:
        """Apply per-shard insert/update deltas to the stacked device arrays
        in place (the sharded mirror of HNSWIndex._try_incremental_sync).
        Returns False when only a full re-stack is correct: growth past the
        padded capacity, upper-array shape growth, or an oversized delta."""
        import dataclasses as _dc

        a = self._arrays
        s = self.num_shards
        n_pad = a.level0.shape[1]
        m0_pad = a.level0.shape[2]
        sent = n_pad - 1
        dim = self.dim

        per = []  # (dirty_ids, rows, new_ids, new_vecs, new_labs)
        any_upper = False
        for i, b in enumerate(self._builders):
            flags = b.dirty_flags
            if flags & 2:
                return False
            n_i = b.size
            if n_i + 1 > n_pad:
                return False
            n_upd = b.flush_updates()
            vec_ids = b.take_vec_dirty(n_upd)
            dirty = b.take_dirty()
            if len(dirty) > n_pad // 2:
                return False
            any_upper |= bool(flags & 1)
            rows = b.export_level0_rows(dirty)
            rows = np.where(rows < 0, sent, rows).astype(np.int32)
            if rows.shape[1] != m0_pad:
                rows = np.concatenate(
                    [
                        rows,
                        np.full(
                            (len(dirty), m0_pad - rows.shape[1]), sent, np.int32
                        ),
                    ],
                    axis=1,
                )
            old_n = self._synced_n[i]
            n_new = n_i - old_n
            nid = np.concatenate(
                [np.arange(old_n, n_i, dtype=np.int32), vec_ids.astype(np.int32)]
            )
            nvec = np.concatenate(
                [
                    b.export_vectors_range(old_n, n_new),
                    b.export_vectors_rows(vec_ids),
                ]
            )
            nlab = np.concatenate(
                [
                    b.export_labels_range(old_n, n_new),
                    np.asarray(
                        [self._shard_labels[i][j] for j in vec_ids], np.int64
                    )
                    if len(vec_ids)
                    else np.zeros(0, np.int64),
                ]
            )
            per.append((dirty, rows, nid, nvec, nlab))

        kb = _bucket(max(len(p[0]) for p in per))
        nb = _bucket(max(len(p[2]) for p in per))
        if kb == 0 and nb == 0 and not any_upper:
            return True

        dirty_ids = np.full((s, kb), sent, np.int32)
        dirty_rows = np.full((s, kb, m0_pad), sent, np.int32)
        new_ids = np.full((s, nb), sent, np.int32)
        new_vecs = np.zeros((s, nb, dim), np.float32)
        new_labs = np.full((s, nb), -1, np.int64)
        for i, (dirty, rows, nid, nvec, nlab) in enumerate(per):
            dirty_ids[i, : len(dirty)] = dirty
            dirty_rows[i, : len(dirty)] = rows
            new_ids[i, : len(nid)] = nid
            new_vecs[i, : len(nid)] = nvec
            new_labs[i, : len(nid)] = nlab
        new_nn = jnp.asarray([b.size for b in self._builders], jnp.int32)

        has_sq = self.space.name == "l2"
        x, sq, level0, labels, nn = _apply_sharded_row_deltas(
            a.vectors,
            a.sq_norms if has_sq else jnp.zeros((1,), jnp.float32),
            a.level0,
            a.labels,
            a.num_nodes,
            jnp.asarray(new_vecs),
            jnp.asarray(new_ids),
            jnp.asarray(new_labs),
            jnp.asarray(dirty_ids),
            jnp.asarray(dirty_rows),
            new_nn,
            has_sq=has_sq,
        )
        rep = dict(
            vectors=x,
            sq_norms=sq if has_sq else a.sq_norms,
            level0=level0,
            labels=labels,
            num_nodes=nn,
        )

        if any_upper:
            # upper arrays are small (~N/M rows): re-derive wholesale. When
            # inserts outgrow the stacked padding, GROW it (with headroom so
            # the next wave stays a delta) instead of re-stacking everything
            # — growth only recompiles the search jit; vectors and level-0
            # links are untouched (single-chip parity:
            # HNSWIndex._try_incremental_sync re-derives upper shapes
            # freely, models/hnsw.py flags&1 branch).
            from hnsw_tpu.core.graph import upper_host_arrays

            exports = []
            ml_need, u_need, mm_need = 0, 0, 0
            for b in self._builders:
                g = b.export_graph()
                up_i, us_i = upper_host_arrays(g, n_pad)
                exports.append((up_i, us_i, g.entry_point))
                if up_i.shape[0]:
                    ml_need = max(ml_need, up_i.shape[0])
                    u_need = max(u_need, up_i.shape[1])
                    mm_need = max(mm_need, up_i.shape[2])
            max_l = max(a.upper.shape[1], ml_need)
            u_pad = a.upper.shape[2]
            if u_need > u_pad:
                u_pad = round_up(u_need + max(8, u_need // 16), 8)
            max_m = max(a.upper.shape[3], mm_need)
            upper = np.full((s, max_l, u_pad, max_m), sent, dtype=np.int32)
            upper_slot = np.full((s, max_l, n_pad), u_pad - 1, dtype=np.int32)
            entry = np.zeros(s, dtype=np.int32)
            for i, (up_i, us_i, ep_i) in enumerate(exports):
                if up_i.shape[0]:
                    upper[i, : up_i.shape[0], : up_i.shape[1], : up_i.shape[2]] = (
                        up_i
                    )
                    # shard-local dummy slot -> stacked dummy (see
                    # build_sharded_arrays)
                    upper_slot[i, : us_i.shape[0]] = np.where(
                        us_i == up_i.shape[1] - 1, u_pad - 1, us_i
                    )
                entry[i] = ep_i
            spec = lambda *rest: NamedSharding(
                self.mesh, P(self.shard_axis, *rest)
            )
            rep.update(
                upper=jax.device_put(jnp.asarray(upper), spec(None, None, None)),
                upper_slot=jax.device_put(
                    jnp.asarray(upper_slot), spec(None, None)
                ),
                entry_point=jax.device_put(jnp.asarray(entry), spec()),
            )
        self._arrays = _dc.replace(a, **rep)
        self._synced_n = [b.size for b in self._builders]
        return True

    # -- mutation (single-chip parity: add/delete by external label) --------

    def add_items(self, data: np.ndarray, labels: np.ndarray | None = None) -> None:
        """Incremental insert: new rows are distributed to the smallest
        shards (keeps the round-robin balance); labels that already exist
        route to their owning shard as in-place updates. Device arrays
        re-sync as per-shard row deltas on the next search (full re-stack
        only on capacity growth)."""
        assert self._builders is not None, "call build() first"
        data = self.space.preprocess(data)
        if labels is None:
            start = sum(b.size for b in self._builders)
            labels = np.arange(start, start + data.shape[0], dtype=np.int64)
        labels = np.asarray(labels, dtype=np.int64).reshape(-1)
        exists = np.asarray(
            [int(l) in self._label_map for l in labels], dtype=bool
        )
        # in-place updates go to the shard that owns the label
        for row, lab in zip(data[exists], labels[exists]):
            i, local = self._label_map[int(lab)]
            self._builders[i].add_batch(row[None, :], np.asarray([lab]))
            self._shard_deleted[i][local] = False
        data, labels = data[~exists], labels[~exists]
        sizes = np.asarray([b.size for b in self._builders])
        # assign items round-robin starting from the currently smallest shards
        rank = np.argsort(sizes, kind="stable")
        shard_of = rank[np.arange(data.shape[0]) % self.num_shards]
        for i in range(self.num_shards):
            sel = shard_of == i
            if not sel.any():
                continue
            first_local = self._builders[i].size
            self._builders[i].add_batch(data[sel], labels[sel])
            labs = labels[sel]
            self._shard_labels[i] = np.concatenate([self._shard_labels[i], labs])
            self._shard_deleted[i] = np.concatenate(
                [self._shard_deleted[i], np.zeros(len(labs), bool)]
            )
            for off, lab in enumerate(labs):
                self._label_map[int(lab)] = (i, first_local + off)
        self._pending_delta = True  # row-delta re-sync on next search

    def mark_deleted(self, label: int) -> None:
        loc = self._label_map.get(int(label))
        if loc is None:
            raise KeyError(f"label {label} not in index")
        shard, local = loc
        self._builders[shard].mark_deleted(label)
        self._shard_deleted[shard][local] = True

    def unmark_deleted(self, label: int) -> None:
        loc = self._label_map.get(int(label))
        if loc is None:
            raise KeyError(f"label {label} not in index")
        shard, local = loc
        self._builders[shard].unmark_deleted(label)
        self._shard_deleted[shard][local] = False

    @property
    def num_elements(self) -> int:
        return sum(b.size for b in self._builders)

    # -- persistence ---------------------------------------------------------

    def save(self, path_prefix: str) -> None:
        """Write one native checkpoint per shard: {prefix}.shard{i}.npz +
        {prefix}.meta.json."""
        import json

        assert self._builders is not None, "nothing built"
        for i, b in enumerate(self._builders):
            from hnsw_tpu.io.checkpoint import save_checkpoint

            save_checkpoint(
                f"{path_prefix}.shard{i}.npz",
                b.export_graph(),
                b.export_vectors(),
                b.export_deleted(),
                meta={"space": self.space.persist_name, "dim": self.dim, "m": self.m},
            )
        with open(f"{path_prefix}.meta.json", "w") as f:
            json.dump(
                {
                    "num_shards": self.num_shards,
                    "space": self.space.persist_name,
                    "dim": self.dim,
                    "m": self.m,
                    "ef_construction": self.ef_construction,
                },
                f,
            )

    def load(self, path_prefix: str) -> None:
        """Restore builders + device arrays from a save()d checkpoint set
        (shard count must match this index's mesh)."""
        import json

        from hnsw_tpu.io.checkpoint import load_checkpoint
        from hnsw_tpu.native.hnsw_builder import NativeHNSWBuilder

        with open(f"{path_prefix}.meta.json") as f:
            meta = json.load(f)
        assert meta["num_shards"] == self.num_shards, (
            f"checkpoint has {meta['num_shards']} shards, mesh has {self.num_shards}"
        )
        self._builders = []
        shards = []
        for i in range(self.num_shards):
            g, vectors, deleted, _ = load_checkpoint(f"{path_prefix}.shard{i}.npz")
            b = NativeHNSWBuilder.from_graph(
                g, vectors, deleted, space=self.space.name,
                ef_construction=meta["ef_construction"],
            )
            self._builders.append(b)
            shards.append((g, vectors))
        self._arrays = build_sharded_arrays(
            shards, self.space, self.mesh, self.shard_axis,
        )
        for b in self._builders:
            b.clear_dirty()
        self._synced_n = [b.size for b in self._builders]
        self._pending_delta = False
        self.last_sync_mode = "full"
        self._reindex_labels()

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        ef: int = 200,
        expand: int = 1,
        *,
        filter_labels: np.ndarray | None = None,
        entry_labels: np.ndarray | None = None,
        stop_patience: int = 0,
        stop_frontier: float = 0.0,
        frontier_rank: int = 0,
        max_iters: int = 0,
        entry_seeds: int = 0,
        seed_pool: int = 0,
        stop_fn: object = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched kNN over all shards (single-chip parity features:
        `filter_labels` is a bool mask over external labels, delete-marked
        elements are always excluded, `entry_labels` optionally overrides the
        per-query entry point by external label — each shard maps the label
        to its local id or falls back to its own entry point). The speed-mode
        knobs (`stop_patience`, `stop_frontier`, `max_iters`) match
        single-chip `SearchParams`; the lockstep hop budget applies per
        shard-local beam. `entry_seeds` enables the landmark-seeded entry
        mode per shard (SearchParams.entry_seeds parity); `seed_pool`
        enlarges each shard's landmark pool with strided level-0 nodes
        (SearchParams.seed_pool parity)."""
        q_np = self.space.preprocess(queries)
        b0 = q_np.shape[0]
        # pad each dp-local batch to a multiple of 16: nearby batch sizes
        # share one compiled program
        unit = 16 * (self.mesh.shape[self.dp_axis] if self.dp_axis else 1)
        b_pad = ((b0 + unit - 1) // unit) * unit
        if b_pad != b0:
            q_np = np.concatenate(
                [q_np, np.zeros((b_pad - b0, self.dim), np.float32)]
            )

        arrays = self.arrays
        s = self.num_shards
        n_pad = arrays.level0.shape[1]
        any_deleted = any(d.any() for d in self._shard_deleted)
        has_mask = any_deleted or filter_labels is not None
        fl = (
            np.asarray(filter_labels, dtype=bool)
            if filter_labels is not None else None
        )
        if fl is not None and fl.ndim == 2:
            # per-query masks (single-chip parity): [B, L] over external
            # labels -> [S, B_pad, n_pad] over shard-local ids; padded
            # queries get all-False rows (their results are discarded)
            assert fl.shape[0] == b0, (
                f"filter_labels rows {fl.shape[0]} != batch {b0}"
            )
            elig = np.zeros((s, b_pad, n_pad), dtype=bool)
            for i in range(s):
                n_i = len(self._shard_deleted[i])
                ok = fl[:, self._shard_labels[i]]
                ok &= ~self._shard_deleted[i][None, :]
                elig[i, :b0, :n_i] = ok
            eligible = jnp.asarray(elig)
        elif has_mask:
            elig = np.ones((s, n_pad), dtype=bool)
            for i in range(s):
                n_i = len(self._shard_deleted[i])
                ok = ~self._shard_deleted[i]
                if fl is not None:
                    ok = ok & fl[self._shard_labels[i]]
                elig[i, :n_i] = ok
            eligible = jnp.asarray(elig)
        else:
            eligible = jnp.ones((s, 1), dtype=bool)

        has_entry = entry_labels is not None
        if has_entry:
            ent = np.full((s, b_pad), -1, dtype=np.int32)
            for j, lab in enumerate(np.asarray(entry_labels).reshape(-1)):
                loc = self._label_map.get(int(lab))
                if loc is not None:
                    ent[loc[0], j] = loc[1]
            entry_ids = jnp.asarray(ent)
        else:
            entry_ids = jnp.zeros((s, 1), dtype=jnp.int32)

        landmarks = None
        if entry_seeds > 0 and not has_entry:
            landmarks = self._landmarks_for(arrays, pool_extra=seed_pool)
            if landmarks is None:
                entry_seeds = 0

        d, l = sharded_search(
            arrays,
            jnp.asarray(q_np),
            eligible,
            entry_ids,
            landmarks,
            k=k,
            ef=max(ef, k),
            space=self.space.name,
            expand=expand,
            mesh=self.mesh,
            dp_axis=self.dp_axis,
            shard_axis=self.shard_axis,
            has_mask=has_mask,
            has_entry=has_entry,
            stop_patience=stop_patience,
            stop_frontier=stop_frontier,
            frontier_rank=frontier_rank,
            max_iters=max_iters,
            entry_seeds=entry_seeds,
            stop_fn=stop_fn,
        )
        return np.asarray(d)[:b0], np.asarray(l)[:b0]

    def _landmarks_for(self, arrays: ShardedIndexArrays,
                       pool_extra: int = 0):
        """Per-shard landmark arrays for the seeded entry mode, cached per
        (device-sync generation, pool_extra) — every rebuild/delta replaces
        `_arrays` with a fresh object, so identity keying is exact."""
        cache = getattr(self, "_landmark_cache", None)
        if (cache is not None and cache[0] is arrays
                and cache[1] == pool_extra):
            return cache[2]
        lm = sharded_landmark_arrays(arrays, self.mesh, self.shard_axis,
                                     pool_extra=pool_extra)
        self._landmark_cache = (arrays, pool_extra, lm)
        return lm
