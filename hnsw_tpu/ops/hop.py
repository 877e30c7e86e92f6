"""The level-0 hop: expand the chosen beam entries of every query.

One hop reads each chosen node's M0 neighbor ids from the level-0 adjacency
and computes the query's distance to each of those neighbors — the inner
loop of the reference's searchBaseLayerST (hnswlib/hnswalg.h:377-435),
batched over queries and expansion slots. Two implementations:

- "xla": `jnp.take` of the id rows, then `distance.gather_dist` — a row
  gather feeding a batched contraction, compiled by XLA on any backend.
- "triton": a Pallas kernel for the Triton route. One program takes one
  (query, slot) pair, loads the node's id row, gathers those M0 vector rows
  with masked loads and reduces the distance in fp32 registers, so only the
  [M0] distances and ids are written — never the [B, E*M0, D] row block.

`hop_impl` is the single place that picks between them. The kernel
addresses its flat operands with int32 offsets, so it takes only tables of
fewer than 2^31 elements (N*D < 2^31: N < 16.7M at d=128, 2.2M at d=960);
larger ones take the XLA hop, whose row gather has no such limit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from hnsw_tpu.ops.distance import gather_dist

Array = jax.Array


_INT32_LIMIT = 2**31  # the kernel's flat offsets are int32
_NUM_WARPS = 4
_BD = 128  # vector columns per masked load


def _flat_sizes(q, x, level0, chosen) -> tuple[int, ...]:
    """Element counts of every flat operand the kernel indexes; only shapes
    are read, so arrays and ShapeDtypeStructs both do."""
    b, e = chosen.shape
    return (q.size, x.size, level0.size, b * e * level0.shape[1])


def hop_impl(q, x, level0, chosen, platform: str | None = None) -> str:
    """The hop implementation for these operands on a backend: the Triton
    kernel on "gpu" when every flat operand is int32-addressable, XLA
    otherwise. A kernel failure on the GPU is an error, never a silent fall
    back to XLA or to the interpreter."""
    if platform is None:
        platform = jax.default_backend()
    fits = max(_flat_sizes(q, x, level0, chosen)) < _INT32_LIMIT
    return "triton" if platform == "gpu" and fits else "xla"


def hop_xla(q, x, level0, chosen, space, sq_norms=None):
    """XLA hop → (dists [B, E*M0] f32, ids [B, E*M0] int32)."""
    b = q.shape[0]
    nbrs = jnp.take(level0, chosen, axis=0).reshape(b, -1)
    d = gather_dist(q, x, nbrs, space, x_sq_norms=sq_norms)
    return d, nbrs


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _hop_kernel(ch_ref, q_ref, x_ref, lvl_ref, d_ref, id_ref, *, e, m0, dim,
                bd, space):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    i = pl.program_id(0)  # flat (query, slot) index
    node = ch_ref[i]
    m0p = _pow2(m0)
    slot = jnp.arange(m0p, dtype=jnp.int32)
    slot_ok = slot < m0
    ids = plgpu.load(lvl_ref.at[node * m0 + slot], mask=slot_ok, other=0)
    qb = (i // e) * dim
    acc = jnp.zeros((m0p,), jnp.float32)
    for c0 in range(0, _pow2(dim), bd):
        col = c0 + jnp.arange(bd, dtype=jnp.int32)
        col_ok = col < dim
        qv = plgpu.load(q_ref.at[qb + col], mask=col_ok, other=0.0)
        offs = ids[:, None] * dim + col[None, :]
        rows = plgpu.load(
            x_ref.at[offs], mask=slot_ok[:, None] & col_ok[None, :], other=0.0
        ).astype(jnp.float32)
        if space == "l2":
            diff = rows - qv.astype(jnp.float32)[None, :]
            acc += jnp.sum(diff * diff, axis=1)
        else:
            acc += jnp.sum(rows * qv.astype(jnp.float32)[None, :], axis=1)
    if space == "ip":
        acc = 1.0 - acc
    out = i * m0 + slot
    plgpu.store(d_ref.at[out], acc, mask=slot_ok)
    plgpu.store(id_ref.at[out], ids, mask=slot_ok)


@functools.partial(jax.jit, static_argnames=("space", "interpret"))
def hop_triton(q, x, level0, chosen, space, *, interpret=False):
    """Triton-route hop kernel → (dists [B, E*M0] f32, ids [B, E*M0] int32).
    L2 is summed as (x - q)^2 directly, so it needs no norm table."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    if space not in ("l2", "ip"):
        raise ValueError(f"unknown space {space!r} (expected 'l2' or 'ip')")
    if max(_flat_sizes(q, x, level0, chosen)) >= _INT32_LIMIT:
        raise ValueError(
            f"hop_triton addresses operands with int32 offsets; table "
            f"{x.shape} x adjacency {level0.shape} has 2^31 or more elements"
        )
    b, dim = q.shape
    e = chosen.shape[1]
    m0 = level0.shape[1]
    bd = min(_BD, _pow2(dim))
    kernel = functools.partial(
        _hop_kernel, e=e, m0=m0, dim=dim, bd=bd, space=space
    )
    d, ids = pl.pallas_call(
        kernel,
        out_shape=(
            jax.ShapeDtypeStruct((b * e * m0,), jnp.float32),
            jax.ShapeDtypeStruct((b * e * m0,), jnp.int32),
        ),
        grid=(b * e,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=2),
        interpret=interpret,
        name="hnsw_hop",
    )(
        chosen.reshape(-1).astype(jnp.int32),
        q.reshape(-1),
        x.reshape(-1),
        level0.reshape(-1),
    )
    return d.reshape(b, e * m0), ids.reshape(b, e * m0)


def hop_dist(q, x, level0, chosen, space, *, sq_norms=None):
    """One hop for the batch → (dists [B, E*M0], ids [B, E*M0]), by the
    implementation `hop_impl` picks."""
    if hop_impl(q, x, level0, chosen) == "triton":
        return hop_triton(q, x, level0, chosen, space)
    return hop_xla(q, x, level0, chosen, space, sq_norms)
