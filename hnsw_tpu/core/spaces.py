"""Distance spaces.

The reference's SpaceInterface (hnswlib/hnswlib.h:173-184) bundles a scalar
distance function pointer with a data size; concrete spaces are L2Space
(hnswlib/space_l2.h:208-238), InnerProductSpace (hnswlib/space_ip.h:342-380)
and the uint8 L2SpaceI (hnswlib/space_l2.h:294-323). Here a Space is a thin
descriptor: the batched kernels live in hnsw_tpu.ops.distance and are
dispatched by the space's name, and optional preprocessing (e.g. storing
uint8 data upcast on device) happens at index build time.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class Space:
    """Descriptor for a distance space over dim-dimensional vectors."""

    name: str  # 'l2' | 'ip'
    dim: int
    # dtype the vectors are stored in on device (distances always accumulate f32)
    storage_dtype: jnp.dtype = jnp.float32

    def preprocess(self, x: np.ndarray) -> np.ndarray:
        """Host-side normalization applied at insert time."""
        return np.asarray(x, dtype=np.float32).reshape(-1, self.dim)

    def decode(self, x: np.ndarray) -> np.ndarray:
        """Inverse of preprocess for data readback (getDataByLabel parity);
        identity for spaces whose preprocess is lossy-free pass-through."""
        return x

    @property
    def needs_sq_norms(self) -> bool:
        return self.name == "l2"

    @property
    def persist_name(self) -> str:
        """Name written to checkpoints (distinct from the kernel-dispatch
        `name` for derived spaces like cosine, which must reconstruct their
        preprocessing on load)."""
        return self.name


class L2Space(Space):
    """Squared-L2 space (reference: hnswlib/space_l2.h:208-238). Also covers
    the integer L2SpaceI (space_l2.h:294-323): pass uint8 data, it is upcast;
    distances are identical to the reference's scalar int path."""

    def __init__(self, dim: int, storage_dtype=jnp.float32):
        super().__init__(name="l2", dim=dim, storage_dtype=storage_dtype)


class L2SpaceU8(Space):
    """Exact uint8 squared-L2 space — full storage parity with the
    reference's integer L2SpaceI (hnswlib/space_l2.h:294-323), which keeps
    uint8 data losslessly at 1/4 the float bytes.

    Values are shifted by -128 at insert/query time, so stored vectors are
    integers in [-128, 127]: (a-128)-(b-128) == a-b, so every squared-L2
    distance is unchanged, and with d <= 128 all intermediate sums stay
    below 2^24 — exactly representable in f32, while each shifted value is
    exact in TF32 and bf16 — so EVERY device path (the hop at default
    precision, block distances, the rescore) computes the exact integer
    distance the reference's scalar uint8 loop returns."""

    def __init__(self, dim: int, storage_dtype=jnp.float32):
        super().__init__(name="l2", dim=dim, storage_dtype=storage_dtype)

    @property
    def persist_name(self) -> str:
        return "l2u8"

    def preprocess(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x)
        if x.dtype != np.uint8:
            xi = np.rint(np.asarray(x, dtype=np.float32))
            if np.any(xi < 0) or np.any(xi > 255):
                raise ValueError("l2u8 space requires values in [0, 255]")
            x = xi
        return (
            np.asarray(x, dtype=np.float32).reshape(-1, self.dim) - 128.0
        )

    def decode(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x, dtype=np.float32) + 128.0


class IPSpace(Space):
    """Inner-product distance space, d = 1 - <a, b>
    (reference: hnswlib/space_ip.h:342-380)."""

    def __init__(self, dim: int, storage_dtype=jnp.float32):
        super().__init__(name="ip", dim=dim, storage_dtype=storage_dtype)


class CosineSpace(Space):
    """Cosine distance, d = 1 - cos(a, b), as L2-normalize + inner product —
    hnswlib's documented recipe for cosine similarity (the reference repo
    itself ships only L2 + IP, hnswlib/space_ip.h). Queries AND stored
    vectors are normalized host-side in preprocess; the device kernels and
    the native engine run the plain IP path unchanged."""

    def __init__(self, dim: int, storage_dtype=jnp.float32):
        super().__init__(name="ip", dim=dim, storage_dtype=storage_dtype)

    @property
    def persist_name(self) -> str:
        return "cosine"

    def preprocess(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32).reshape(-1, self.dim)
        norms = np.linalg.norm(x, axis=1, keepdims=True)
        return x / np.maximum(norms, 1e-30)


def get_space(name: str, dim: int, storage_dtype=jnp.float32) -> Space:
    if name == "l2":
        return L2Space(dim, storage_dtype)
    if name == "l2u8":
        return L2SpaceU8(dim, storage_dtype)
    if name == "ip":
        return IPSpace(dim, storage_dtype)
    if name == "cosine":
        return CosineSpace(dim, storage_dtype)
    raise ValueError(
        f"unknown space {name!r} (expected 'l2', 'l2u8', 'ip' or 'cosine')"
    )
