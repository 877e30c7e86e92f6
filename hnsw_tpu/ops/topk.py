"""Top-k primitives for distance arrays.

The reference collects top-k with binary heaps (hnswlib/bruteforce.h:106-135,
hnswlib/hnswalg.h:311-440). Heaps are pointer-y and serial; on an accelerator
the right primitives are `lax.top_k` over dense distance blocks and
sorted-array merges.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from hnsw_tpu.ops.distance import pairwise_dist

Array = jax.Array


def topk_smallest(dists: Array, k: int) -> tuple[Array, Array]:
    """Smallest-k along the last axis → (dists [., k] ascending, idx [., k])."""
    neg, idx = jax.lax.top_k(-dists, k)
    return -neg, idx


def merge_sorted_topk(
    d_a: Array, i_a: Array, d_b: Array, i_b: Array, k: int
) -> tuple[Array, Array]:
    """Merge two (dist, id) candidate sets along the last axis, keep the
    smallest k. Inputs need not be sorted. Used for chunked bruteforce
    streaming and the cross-shard all-gather top-k merge."""
    d = jnp.concatenate([d_a, d_b], axis=-1)
    i = jnp.concatenate([i_a, i_b], axis=-1)
    dk, pos = topk_smallest(d, k)
    ik = jnp.take_along_axis(i, pos, axis=-1)
    return dk, ik


@functools.partial(
    jax.jit, static_argnames=("k", "space", "chunk_size", "precision")
)
def bruteforce_topk(
    q: Array,
    x: Array,
    k: int,
    space: str = "l2",
    *,
    chunk_size: int | None = None,
    x_sq_norms: Array | None = None,
    precision: str | None = None,  # "highest" = exact f32 matmul (the
    #   default runs f32 products in TF32 on the GPU, which misranks
    #   near-tie neighbors on clustered data — the recall ORACLE must pass
    #   this; the landmark-seeding hot path keeps the fast default, and a
    #   seed only picks where the beam starts)
) -> tuple[Array, Array]:
    """Exact k-nearest over x [N, D] for queries q [B, D] → (dists, ids).

    Semantics of the reference's BruteforceSearch::searchKnn
    (hnswlib/bruteforce.h:106-135), re-shaped for an accelerator: the N axis
    is streamed in chunks, each chunk is one [B, D] @ [D, C] block-distance
    matmul, and a running [B, k] result is maintained by top-k merge instead
    of a max-heap. Memory traffic is one pass over x.
    """
    n = x.shape[0]
    b = q.shape[0]
    if chunk_size is None:
        # Aim for ~[B, 16k] f32 distance blocks; clamp to N.
        chunk_size = min(n, max(k, 16384))
    if chunk_size % 128 != 0 and chunk_size < n:
        chunk_size = ((chunk_size + 127) // 128) * 128
    chunk_size = min(chunk_size, n)

    if n <= chunk_size:
        d = pairwise_dist(q, x, space, x_sq_norms=x_sq_norms,
                          precision=precision)
        return topk_smallest(d, min(k, n))

    num_chunks = -(-n // chunk_size)
    n_pad = num_chunks * chunk_size
    if n_pad != n:
        x = jnp.pad(x, ((0, n_pad - n), (0, 0)))
        if x_sq_norms is not None:
            x_sq_norms = jnp.pad(x_sq_norms, (0, n_pad - n))

    x_chunks = x.reshape(num_chunks, chunk_size, x.shape[1])
    if x_sq_norms is not None:
        sq_chunks = x_sq_norms.reshape(num_chunks, chunk_size)
    else:
        sq_chunks = None

    init_d = jnp.full((b, k), jnp.inf, dtype=jnp.float32)
    init_i = jnp.full((b, k), -1, dtype=jnp.int32)

    def body(carry, inp):
        best_d, best_i = carry
        if sq_chunks is not None:
            xc, sqc, base = inp
        else:
            xc, base = inp
            sqc = None
        d = pairwise_dist(q, xc, space, x_sq_norms=sqc,
                          precision=precision)  # [B, C]
        # Mask out padding rows (beyond original n).
        col = jax.lax.broadcasted_iota(jnp.int32, d.shape, 1) + base
        d = jnp.where(col < n, d, jnp.inf)
        cd, ci = topk_smallest(d, min(k, chunk_size))
        cid = jnp.take(col[0], ci)  # global ids
        best_d, best_i = merge_sorted_topk(best_d, best_i, cd, cid, k)
        return (best_d, best_i), None

    bases = jnp.arange(num_chunks, dtype=jnp.int32) * chunk_size
    xs = (x_chunks, sq_chunks, bases) if sq_chunks is not None else (x_chunks, bases)
    (best_d, best_i), _ = jax.lax.scan(body, (init_d, init_i), xs)
    return best_d, best_i
