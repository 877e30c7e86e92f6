"""Exact-kNN bruteforce index — the recall oracle.

Reimplements the capability surface of hnswlib::BruteforceSearch
(hnswlib/bruteforce.h:9-172): addPoint, removePoint (swap-delete,
bruteforce.h:64-103), searchKnn (106-135), save/load (138-171) — with the
scan re-expressed as streamed block-distance matmuls + top-k merge
(hnsw_tpu.ops.topk.bruteforce_topk) instead of a scalar loop over a max-heap.

The reference never instantiates its bruteforce class from first-party code;
here it is first-class: every recall test and the experiment harness judge
HNSW results against this oracle.
"""

from __future__ import annotations

import json
import struct

import jax.numpy as jnp
import numpy as np

from hnsw_tpu.core.spaces import Space, get_space
from hnsw_tpu.ops.topk import bruteforce_topk

_MAGIC = b"HTBF0001"


class BruteforceIndex:
    """Exact k-nearest-neighbor index with incremental add/remove."""

    def __init__(self, space: Space, max_elements: int = 0):
        self.space = space
        self.dim = space.dim
        self._data = np.zeros((max(max_elements, 16), space.dim), dtype=np.float32)
        self._labels = np.zeros(max(max_elements, 16), dtype=np.int64)
        self._n = 0
        self._label_to_idx: dict[int, int] = {}
        self._device_cache = None  # (n, x_dev, sq_dev)

    # -- mutation ----------------------------------------------------------

    def add_items(self, data: np.ndarray, labels: np.ndarray) -> None:
        """Bulk insert: one array assignment for all-new labels (the common
        case; reference bruteforce.h:64-85 is an O(1) memcpy per point, so the
        bulk path must not be slower), per-row fallback only when the batch
        contains overwrites or duplicate labels."""
        data = self.space.preprocess(data)
        labels = np.asarray(labels, dtype=np.int64).reshape(-1)
        assert data.shape[0] == labels.shape[0]
        n_new = labels.shape[0]
        if n_new == 0:
            return
        lab_list = labels.tolist()
        all_new = len(set(lab_list)) == n_new and not any(
            l in self._label_to_idx for l in lab_list
        )
        if not all_new:
            for row, lab in zip(data, labels):
                self.add_point(row, int(lab))
            return
        need = self._n + n_new
        if need > self._data.shape[0]:
            cap = max(need, 2 * self._data.shape[0])
            grown = np.zeros((cap, self.dim), np.float32)
            grown[: self._n] = self._data[: self._n]
            self._data = grown
            glab = np.zeros(cap, np.int64)
            glab[: self._n] = self._labels[: self._n]
            self._labels = glab
        self._data[self._n : need] = data
        self._labels[self._n : need] = labels
        self._label_to_idx.update(zip(lab_list, range(self._n, need)))
        self._n = need
        self._device_cache = None

    def add_point(self, vec: np.ndarray, label: int) -> None:
        """Insert or overwrite by label (reference: bruteforce.h:64-85)."""
        vec = self.space.preprocess(vec)[0]
        idx = self._label_to_idx.get(label)
        if idx is None:
            if self._n == self._data.shape[0]:
                grow = max(16, self._data.shape[0])
                self._data = np.concatenate(
                    [self._data, np.zeros((grow, self.dim), np.float32)]
                )
                self._labels = np.concatenate([self._labels, np.zeros(grow, np.int64)])
            idx = self._n
            self._n += 1
            self._label_to_idx[label] = idx
        self._data[idx] = vec
        self._labels[idx] = label
        self._device_cache = None

    def remove_point(self, label: int) -> None:
        """Swap-delete by label (reference: bruteforce.h:88-103)."""
        idx = self._label_to_idx.pop(label)
        last = self._n - 1
        if idx != last:
            self._data[idx] = self._data[last]
            self._labels[idx] = self._labels[last]
            self._label_to_idx[int(self._labels[idx])] = idx
        self._n = last
        self._device_cache = None

    # -- search ------------------------------------------------------------

    @property
    def num_elements(self) -> int:
        return self._n

    def _device_arrays(self):
        if self._device_cache is None or self._device_cache[0] != self._n:
            x = jnp.asarray(self._data[: self._n])
            sq = (
                jnp.sum(x.astype(jnp.float32) ** 2, axis=-1)
                if self.space.needs_sq_norms
                else None
            )
            self._device_cache = (self._n, x, sq)
        return self._device_cache[1], self._device_cache[2]

    def search_knn(
        self, queries: np.ndarray, k: int, filter_labels: np.ndarray | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact top-k for a batch of queries → (dists [B,k], labels [B,k]).

        `filter_labels`: optional bool mask over labels (BaseFilterFunctor
        semantics, hnswlib/hnswlib.h:128-132 / bruteforce.h:114,127): only
        points whose mask is True are eligible results.
        """
        assert self._n > 0, "empty index"
        q = jnp.asarray(self.space.preprocess(queries))
        k_eff = min(k, self._n)
        x, sq = self._device_arrays()
        if filter_labels is not None:
            mask = np.asarray(
                [bool(filter_labels[int(l)]) for l in self._labels[: self._n]]
            )
            # oversearch then filter on host: exact because we sort all N below
            from hnsw_tpu.ops.distance import pairwise_dist

            d = np.array(pairwise_dist(q, x, self.space.name, x_sq_norms=sq,
                                       precision="highest"))
            d[:, ~mask] = np.inf
            idx = np.argsort(d, axis=1)[:, :k_eff]
            dists = np.take_along_axis(d, idx, axis=1)
        else:
            # "highest": the default matmul precision rounds f32 inputs
            # (TF32 on the GPU) and misranks near-tie neighbors on clustered
            # data — this index is the EXACT recall oracle (bruteforce.h
            # semantics), so it pays the precise-matmul cost.
            dists, idx = bruteforce_topk(q, x, k_eff, self.space.name,
                                         x_sq_norms=sq, precision="highest")
            dists, idx = np.asarray(dists), np.asarray(idx)
        labels = self._labels[: self._n][idx]
        return dists, labels

    # -- persistence (reference: bruteforce.h:138-171) ----------------------

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(_MAGIC)
            meta = json.dumps(
                {"space": self.space.persist_name, "dim": self.dim, "n": self._n}
            ).encode()
            f.write(struct.pack("<I", len(meta)))
            f.write(meta)
            f.write(self._data[: self._n].tobytes())
            f.write(self._labels[: self._n].tobytes())

    @classmethod
    def load(cls, path: str) -> "BruteforceIndex":
        with open(path, "rb") as f:
            assert f.read(8) == _MAGIC, "bad bruteforce index file"
            (mlen,) = struct.unpack("<I", f.read(4))
            meta = json.loads(f.read(mlen))
            n, dim = meta["n"], meta["dim"]
            data = np.frombuffer(f.read(n * dim * 4), dtype=np.float32).reshape(n, dim)
            labels = np.frombuffer(f.read(n * 8), dtype=np.int64)
        idx = cls(get_space(meta["space"], dim), max_elements=n)
        idx._data[:n] = data
        idx._labels[:n] = labels
        idx._n = n
        idx._label_to_idx = {int(l): i for i, l in enumerate(labels)}
        return idx
