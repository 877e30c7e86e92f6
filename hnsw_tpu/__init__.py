"""hnsw_tpu — a batched HNSW approximate-nearest-neighbor framework in JAX.

A brand-new JAX/XLA re-design of the capability surface surveyed in
SURVEY.md (reference: hiozings/Research-New-HNSW), run on an NVIDIA GPU:

- Distance spaces (L2, inner-product) as block matmuls instead of the
  reference's SIMD ladders (reference: hnswlib/space_l2.h, hnswlib/space_ip.h).
- HNSW graphs as padded-CSR device arrays instead of flat pointer-chased
  linklists (reference: hnswlib/hnswalg.h:120-141).
- Search as a batched, fixed-ef masked beam traversal under jit/vmap instead
  of heap-based pointer chasing (reference: hnswlib/hnswalg.h:311-440).
- An exact-kNN bruteforce oracle (reference: hnswlib/bruteforce.h).
- A native C++ graph builder + vector store runtime layer (reference:
  index_builder/build.cpp, storage_service/).
- Sharded multi-device search with an all-gather top-k merge.
"""

from hnsw_tpu.core.graph import HNSWGraph, graph_device_arrays
from hnsw_tpu.core.spaces import Space, L2Space, IPSpace, CosineSpace, get_space
from hnsw_tpu.models.bruteforce import BruteforceIndex
from hnsw_tpu.models.hnsw import HNSWIndex, SearchParams
from hnsw_tpu.models.multivector import MultiVectorIndex, epsilon_search

__version__ = "0.1.0"

__all__ = [
    "HNSWGraph",
    "graph_device_arrays",
    "Space",
    "L2Space",
    "IPSpace",
    "CosineSpace",
    "get_space",
    "BruteforceIndex",
    "HNSWIndex",
    "SearchParams",
    "MultiVectorIndex",
    "epsilon_search",
]
