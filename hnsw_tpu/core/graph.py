"""Padded-CSR HNSW graph containers.

The reference keeps the graph as flat per-node byte blobs: level-0 links,
vector and label interleaved in one allocation, upper links in per-node
malloc'd lists (hnswlib/hnswalg.h:120-141, 486-503). That layout is built for
pointer chasing. The device layout is dense padded arrays:

- ``level0``      [N, maxM0] int32, sentinel -1 for absent links
- ``upper``       [L, U, M]  int32, rows are *slots*; level l>=1 adjacency
- ``upper_slot``  [L, N]     int32, node id -> slot at that level (-1 absent)
- ``node_level``  [N]        int32, the per-node top level
- ``labels``      [N]        int64, internal id -> external label

so the whole graph is gatherable: ``level0[ids]`` is one HBM gather, and the
upper-layer greedy descent is ``upper[l, upper_slot[l, id]]``. On device the
sentinel is remapped to a dummy padded row so every gather is in-range.

``check_integrity`` reimplements the invariants of
hnswlib::HierarchicalNSW::checkIntegrity (hnswlib/hnswalg.h:1381-1410).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class HNSWGraph:
    """Host-side (numpy) padded-CSR HNSW graph. Sentinel neighbor id is -1."""

    level0: np.ndarray  # [N, maxM0] int32
    upper: np.ndarray  # [L, U, M] int32 (L may be 0)
    upper_slot: np.ndarray  # [L, N] int32
    node_level: np.ndarray  # [N] int32
    labels: np.ndarray  # [N] int64
    entry_point: int
    max_level: int

    @property
    def num_nodes(self) -> int:
        return int(self.level0.shape[0])

    @property
    def max_m0(self) -> int:
        return int(self.level0.shape[1])

    @property
    def max_m(self) -> int:
        return int(self.upper.shape[2]) if self.upper.size else 0

    def neighbors(self, node: int, level: int) -> np.ndarray:
        """Valid neighbor ids of `node` at `level` (unpadded)."""
        if level == 0:
            row = self.level0[node]
        else:
            slot = self.upper_slot[level - 1, node]
            if slot < 0:
                return np.empty((0,), dtype=np.int32)
            row = self.upper[level - 1, slot]
        return row[row >= 0]


def check_integrity(g: HNSWGraph, require_inbound: bool = True) -> None:
    """Graph invariants, mirroring hnswlib/hnswalg.h:1381-1410: every link
    in range, no self-loops, no duplicate links per list, and every node
    reachable by at least one inbound level-0 edge (when N > 1).

    `require_inbound=False` skips the inbound check: the neighbor-selection
    heuristic inherently orphans ~0.5% of nodes' in-degree at N>=50k (true
    of the reference algorithm as well — its checkIntegrity would fail the
    same way, and nothing in the reference ever calls it, SURVEY.md §4)."""
    n = g.num_nodes
    if n == 0:
        return
    assert 0 <= g.entry_point < n, f"entry_point {g.entry_point} out of range"
    assert g.node_level[g.entry_point] == g.max_level, "entry point not at max level"

    inbound = np.zeros(n, dtype=np.int64)
    for node in range(n):
        for level in range(int(g.node_level[node]) + 1):
            nbrs = g.neighbors(node, level)
            if nbrs.size == 0:
                continue
            assert nbrs.min() >= 0 and nbrs.max() < n, (
                f"node {node} level {level}: neighbor out of range"
            )
            assert not np.any(nbrs == node), f"node {node} level {level}: self-loop"
            assert len(np.unique(nbrs)) == nbrs.size, (
                f"node {node} level {level}: duplicate links"
            )
            # neighbors at level l must themselves exist at level l
            if level > 0:
                assert np.all(g.node_level[nbrs] >= level), (
                    f"node {node} level {level}: neighbor below level"
                )
            if level == 0:
                inbound[nbrs] += 1
    if n > 1 and require_inbound:
        assert np.all(inbound > 0), (
            f"{int(np.sum(inbound == 0))} nodes with no inbound level-0 edges"
        )


# ---------------------------------------------------------------------------
# Device-side arrays.
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Device-resident graph. All ids are in [0, n_pad); ids >= num_nodes are
    the dummy padding row (the traversal masks them by id >= num_nodes).

    `upper` may have L=0 rows (single-level graph): shapes stay static.
    """

    level0: Array  # [N_pad, maxM0] int32
    upper: Array  # [L, U_pad, M] int32
    upper_slot: Array  # [L, N_pad] int32
    labels: Array  # [N_pad] int64
    entry_point: Array  # [] int32
    num_nodes: Array  # [] int32

    @property
    def n_pad(self) -> int:
        return self.level0.shape[0]

    @property
    def max_level(self) -> int:
        return self.upper.shape[0]


def graph_device_arrays(g: HNSWGraph, n_pad: int | None = None) -> DeviceGraph:
    """Convert a host graph to device arrays. Sentinel -1 links are remapped
    to `n_pad - 1` (a guaranteed-dummy row) so all gathers are in-range; the
    traversal masks with `id >= num_nodes`."""
    n = g.num_nodes
    if n_pad is None:
        n_pad = round_up(n + 1, 128)
    assert n_pad > n, "n_pad must leave at least one dummy row"
    sent = n_pad - 1

    def pad_ids(a: np.ndarray, rows: int) -> np.ndarray:
        out = np.full((rows,) + a.shape[1:], sent, dtype=np.int32)
        out[: a.shape[0]] = np.where(a < 0, sent, a)
        return out

    level0 = pad_ids(g.level0, n_pad)
    # pad link width to a multiple of 16 (bf16 sublane tiling of the inline
    # neighbor-vector table derived from this array)
    m0_pad = max(16, -(-level0.shape[1] // 16) * 16)
    if m0_pad != level0.shape[1]:
        level0 = np.concatenate(
            [level0, np.full((n_pad, m0_pad - level0.shape[1]), sent, np.int32)],
            axis=1,
        )

    upper, upper_slot = upper_host_arrays(g, n_pad)

    labels = np.full((n_pad,), -1, dtype=np.int64)
    labels[:n] = g.labels

    return DeviceGraph(
        level0=jnp.asarray(level0),
        upper=jnp.asarray(upper),
        upper_slot=jnp.asarray(upper_slot),
        labels=jnp.asarray(labels),
        entry_point=jnp.asarray(g.entry_point, dtype=jnp.int32),
        num_nodes=jnp.asarray(n, dtype=jnp.int32),
    )


def upper_host_arrays(g: HNSWGraph, n_pad: int) -> tuple[np.ndarray, np.ndarray]:
    """Padded upper-level adjacency + slot map as host arrays (sentinel
    remapped); shared by the full upload and the incremental-sync path (the
    upper arrays are small — ~N/M rows — and re-derived wholesale)."""
    n = g.num_nodes
    sent = n_pad - 1
    ml = g.max_level
    if ml > 0 and g.upper.size:
        u = g.upper.shape[1]
        u_pad = round_up(u + 1, 8)
        upper = np.full((ml, u_pad, g.max_m), sent, dtype=np.int32)
        upper[:, :u] = np.where(g.upper < 0, sent, g.upper)
        upper_slot = np.full((ml, n_pad), u_pad - 1, dtype=np.int32)
        upper_slot[:, :n] = np.where(g.upper_slot < 0, u_pad - 1, g.upper_slot)
    else:
        upper = np.zeros((0, 1, 1), dtype=np.int32)
        upper_slot = np.zeros((0, n_pad), dtype=np.int32)
    return upper, upper_slot


def pad_vectors(x: np.ndarray, n_pad: int, dtype=np.float32) -> np.ndarray:
    """Pad the vector table to n_pad rows (dummy rows are zero; traversal
    masks their distances, so values are irrelevant)."""
    n, d = x.shape
    out = np.zeros((n_pad, d), dtype=dtype)
    out[:n] = x
    return out
