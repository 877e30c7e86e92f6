"""Distance kernels.

The reference implements distances as hand-rolled SIMD ladders with runtime
CPU-capability dispatch (reference: hnswlib/space_l2.h:216-235,
hnswlib/space_ip.h:348-380). On an accelerator the idiomatic shape is the
opposite: batch everything into matrix products —

    ||q - x||^2 = ||q||^2 + ||x||^2 - 2 <q, x>

so a [B, D] x [N, D] pairwise distance is one [B, D] @ [D, N] matmul plus a
rank-1 row/col correction that XLA fuses into the matmul epilogue. The
per-visit scalar distance of the reference's traversal loop
(hnswlib/hnswalg.h:377-435) becomes `gather_*`: a batched gather of neighbor
rows followed by a batched contraction.

Data may be stored bfloat16; accumulation always happens in float32 via
`preferred_element_type`. Every kernel takes `precision`: the default lets
the GPU run f32 products in TF32 (about three decimal digits), "highest"
keeps full f32 — exactness-contract callers (the recall oracle, the exact
rescore) pass "highest".
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

Array = jax.Array


# ---------------------------------------------------------------------------
# Pairwise (dense [B, N]) distances — the bruteforce / block-distance path.
# ---------------------------------------------------------------------------


def pairwise_l2_sq(
    q: Array, x: Array, *, x_sq_norms: Array | None = None, precision=None
) -> Array:
    """Squared-L2 distance between every row of q [B, D] and x [N, D] → [B, N].

    Equivalent semantics to the reference's L2Sqr (hnswlib/space_l2.h:7-24)
    evaluated on all pairs at once, expressed as one matmul.
    `x_sq_norms` ([N]) may be precomputed and passed in to amortize across
    calls (the index stores it alongside the vectors).

    `precision`: forwarded to the matmul. The default may round f32 inputs
    (TF32 on the GPU) — fine for approximate search, but on clustered data
    with near-tie neighbor ranks it scrambles the top-k. EXACTNESS-CONTRACT
    callers (the bruteforce recall oracle) must pass "highest".
    """
    q32 = q.astype(jnp.float32)
    qq = jnp.sum(q32 * q32, axis=-1, keepdims=True)  # [B, 1]
    if x_sq_norms is None:
        x32 = x.astype(jnp.float32)
        x_sq_norms = jnp.sum(x32 * x32, axis=-1)  # [N]
    qx = jax.lax.dot_general(
        q,
        x,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=precision,
    )  # [B, N]
    d = qq + x_sq_norms[None, :] - 2.0 * qx
    # Guard tiny negative values from cancellation; distances are >= 0.
    return jnp.maximum(d, 0.0)


def pairwise_ip_dist(q: Array, x: Array, *, precision=None) -> Array:
    """Inner-product distance 1 - <q, x> for all pairs → [B, N].

    Same semantics as the reference's InnerProductDistance
    (hnswlib/space_ip.h:17-23), batched into one matmul.
    """
    qx = jax.lax.dot_general(
        q,
        x,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=precision,
    )
    return 1.0 - qx


def pairwise_dist(
    q: Array, x: Array, space: str, *, x_sq_norms: Array | None = None,
    precision=None,
) -> Array:
    if space == "l2":
        return pairwise_l2_sq(q, x, x_sq_norms=x_sq_norms, precision=precision)
    if space == "ip":
        return pairwise_ip_dist(q, x, precision=precision)
    raise ValueError(f"unknown space {space!r} (expected 'l2' or 'ip')")


# ---------------------------------------------------------------------------
# Gathered (per-query neighbor set) distances — the traversal hot path.
# ---------------------------------------------------------------------------


def _gather_rows(x: Array, ids: Array) -> Array:
    """x [N, D], ids [B, K] int32 → [B, K, D]. ids must be in-range
    (callers map sentinel ids to the padded dummy row N-1)."""
    return jnp.take(x, ids, axis=0)


def gather_l2_sq(
    q: Array,
    x: Array,
    ids: Array,
    *,
    x_sq_norms: Array | None = None,
    precision=None,
) -> Array:
    """Squared-L2 from q[b] to x[ids[b, k]] → [B, K].

    Replaces the reference's one-SIMD-call-per-visited-neighbor inner loop
    (hnswlib/hnswalg.h:377-435) with one batched row gather + batched
    contraction. With x_sq_norms resident, only D floats per neighbor move
    and the contraction is a batched GEMV.
    """
    rows = _gather_rows(x, ids)  # [B, K, D]
    q32 = q.astype(jnp.float32)
    qq = jnp.sum(q32 * q32, axis=-1)[:, None]  # [B, 1]
    if x_sq_norms is not None:
        xx = jnp.take(x_sq_norms, ids, axis=0)  # [B, K]
    else:
        r32 = rows.astype(jnp.float32)
        xx = jnp.sum(r32 * r32, axis=-1)
    qx = jax.lax.dot_general(
        rows,
        q,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
        precision=precision,
    )  # [B, K]
    return jnp.maximum(qq + xx - 2.0 * qx, 0.0)


def gather_ip_dist(q: Array, x: Array, ids: Array, *, precision=None) -> Array:
    """Inner-product distance 1 - <q[b], x[ids[b,k]]> → [B, K]."""
    rows = _gather_rows(x, ids)
    qx = jax.lax.dot_general(
        rows,
        q,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
        precision=precision,
    )
    return 1.0 - qx


def gather_dist(
    q: Array,
    x: Array,
    ids: Array,
    space: str,
    *,
    x_sq_norms: Array | None = None,
    precision=None,
) -> Array:
    if space == "l2":
        return gather_l2_sq(q, x, ids, x_sq_norms=x_sq_norms,
                            precision=precision)
    if space == "ip":
        return gather_ip_dist(q, x, ids, precision=precision)
    raise ValueError(f"unknown space {space!r} (expected 'l2' or 'ip')")


# ---------------------------------------------------------------------------
# Reference-parity scalar helpers (used by tests and the host builder glue).
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("space",))
def dist_one(a: Array, b: Array, space: str = "l2") -> Array:
    """Single-pair distance, for parity tests against the scalar reference
    semantics (hnswlib/space_l2.h:7-24, hnswlib/space_ip.h:7-23)."""
    a = a.reshape(1, -1)
    b = b.reshape(1, -1)
    return pairwise_dist(a, b, space)[0, 0]
