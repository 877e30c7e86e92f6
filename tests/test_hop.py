"""The level-0 hop (ops/hop.py): distances from each query to the neighbors
of its chosen nodes, against a float64 NumPy reference, with sentinel ids
mixed in; the single implementation choice; the Triton-route kernel in
interpret mode."""

import numpy as np
import pytest

from hnsw_tpu.core.spaces import get_space

N, M0, B, E = 300, 32, 16, 2


def _case(space_name, dim, seed=0, m0=M0):
    """(space, x [N, D] stored form, level0 [N, M0], chosen [B, E], q [B, D])
    with the padding row N-1 as the sentinel: zero vector, all-sentinel
    links, and sentinel entries mixed into level0 and chosen."""
    rng = np.random.default_rng(seed)
    sp = get_space(space_name, dim)
    if space_name == "l2u8":
        raw = rng.integers(0, 256, size=(N, dim)).astype(np.uint8)
        qraw = rng.integers(0, 256, size=(B, dim)).astype(np.uint8)
    else:
        raw = rng.normal(size=(N, dim)).astype(np.float32)
        qraw = rng.normal(size=(B, dim)).astype(np.float32)
    x = sp.preprocess(raw)
    x[N - 1] = 0.0
    q = sp.preprocess(qraw)
    level0 = rng.integers(0, N - 1, size=(N, m0)).astype(np.int32)
    level0[:, m0 - 6:] = N - 1
    level0[N - 1] = N - 1
    chosen = rng.integers(0, N - 1, size=(B, E)).astype(np.int32)
    chosen[::3, 1] = N - 1
    return sp, x, level0, chosen, q


def _reference(sp, x, level0, chosen, q):
    """float64 distances [B, E*M0] and the f32 forward-error scale of each
    entry (sum_i |q_i x_i| plus the norms the L2 expansion adds)."""
    ids = level0[chosen].reshape(chosen.shape[0], -1)
    rows = x.astype(np.float64)[ids]
    q64 = q.astype(np.float64)[:, None, :]
    scale = np.abs(rows * q64).sum(-1)
    if sp.name == "l2":
        ref = ((rows - q64) ** 2).sum(-1)
        scale = 2 * scale + (rows**2).sum(-1) + (q64**2).sum(-1)
    else:
        ref = 1.0 - (rows * q64).sum(-1)
        scale = scale + 1.0
    return ids, ref, scale


@pytest.mark.parametrize("dim", [96, 128, 960])
@pytest.mark.parametrize("space_name", ["l2", "ip", "cosine", "l2u8"])
def test_xla_hop_matches_float64(space_name, dim):
    import jax.numpy as jnp

    from hnsw_tpu.ops.hop import hop_xla

    sp, x, level0, chosen, q = _case(space_name, dim)
    xd = jnp.asarray(x)
    sq = jnp.sum(xd * xd, axis=-1) if sp.needs_sq_norms else None
    d, ids = hop_xla(jnp.asarray(q), xd, jnp.asarray(level0),
                     jnp.asarray(chosen), sp.name, sq)
    ids_ref, ref, scale = _reference(sp, x, level0, chosen, q)
    np.testing.assert_array_equal(np.asarray(ids), ids_ref)
    d = np.asarray(d).astype(np.float64)
    if space_name == "l2u8":
        # integer data: every product and partial sum is exact in f32
        np.testing.assert_array_equal(d, ref)
    else:
        err = np.abs(d - ref)
        assert np.all(err <= 1e-5 * np.abs(ref) + 1e-6 * scale), (
            float((err / scale).max())
        )


def _shapes(n, dim, m0=M0, b=B):
    """ShapeDtypeStructs standing for hop operands: nothing is allocated."""
    import jax
    import jax.numpy as jnp

    return (jax.ShapeDtypeStruct((b, dim), jnp.float32),
            jax.ShapeDtypeStruct((n, dim), jnp.float32),
            jax.ShapeDtypeStruct((n, m0), jnp.int32),
            jax.ShapeDtypeStruct((b, E), jnp.int32))


def test_hop_impl_is_xla_off_gpu():
    import jax

    from hnsw_tpu.ops.hop import hop_impl

    ops = _shapes(N, 128)
    assert jax.default_backend() == "cpu"
    assert hop_impl(*ops) == "xla"
    assert hop_impl(*ops, platform="cpu") == "xla"
    assert hop_impl(*ops, platform="gpu") == "triton"


@pytest.mark.parametrize("n,dim,m0,impl", [
    (2**31 // 128 - 1, 128, 32, "triton"),  # N*D = 2^31 - 128
    (2**31 // 128, 128, 32, "xla"),         # N*D = 2^31: offsets wrap
    (2**31 // 960 + 1, 960, 32, "xla"),     # d=960 past the limit
    (2**31 // 64, 16, 64, "xla"),           # N*M0 = 2^31 (the id table)
])
def test_hop_impl_keeps_kernel_int32_addressable(n, dim, m0, impl):
    """The kernel's flat offsets are int32: on the GPU a table (or
    adjacency) of 2^31 or more elements takes the XLA hop."""
    from hnsw_tpu.ops.hop import hop_impl

    assert hop_impl(*_shapes(n, dim, m0), platform="gpu") == impl


def test_triton_hop_refuses_tables_past_int32():
    import jax

    from hnsw_tpu.ops.hop import hop_triton

    with pytest.raises(ValueError, match="int32"):
        jax.eval_shape(
            lambda *a: hop_triton(*a, "l2", interpret=True),
            *_shapes(2**31 // 128, 128),
        )
    d, ids = jax.eval_shape(
        lambda *a: hop_triton(*a, "l2", interpret=True),
        *_shapes(2**31 // 128 - 1, 128),
    )
    assert d.shape == ids.shape == (B, E * M0)


@pytest.mark.parametrize("m0,dtype", [(32, "float32"), (24, "float32"),
                                      (32, "bfloat16")])
@pytest.mark.parametrize("dim", [96, 128, 960])
@pytest.mark.parametrize("space_name", ["l2", "ip"])
def test_triton_hop_interpret_matches_float64(space_name, dim, m0, dtype):
    """The Triton-route kernel, run by the Pallas interpreter: ids equal
    the adjacency rows, distances match float64 to f32 rounding (it sums
    (x - q)^2 directly), at widths and link counts that are and are not
    powers of two, from an f32 or a bf16 vector table."""
    import jax.numpy as jnp

    from hnsw_tpu.ops.hop import hop_triton

    sp, x, level0, chosen, q = _case(space_name, dim, seed=1, m0=m0)
    xd = jnp.asarray(x).astype(dtype)
    d, ids = hop_triton(jnp.asarray(q), xd, jnp.asarray(level0),
                        jnp.asarray(chosen), sp.name, interpret=True)
    x = np.asarray(xd.astype(jnp.float32))  # the table's stored values
    ids_ref, ref, scale = _reference(sp, x, level0, chosen, q)
    np.testing.assert_array_equal(np.asarray(ids), ids_ref)
    err = np.abs(np.asarray(d).astype(np.float64) - ref)
    assert np.all(err <= 1e-5 * np.abs(ref) + 1e-6 * scale), (
        float((err / scale).max())
    )


def test_search_batch_hop_override_agrees(rng):
    """Pinning `hop_impl` routes search_batch's level-0 expansion through
    the named implementation: the kernel (interpreted here) and XLA return
    the same neighbors."""
    import functools
    from unittest import mock

    import jax
    import jax.numpy as jnp

    from hnsw_tpu.models.hnsw import HNSWIndex
    from hnsw_tpu.ops import hop
    from hnsw_tpu.ops.traversal import search_batch

    x = rng.normal(size=(500, 16)).astype(np.float32)
    idx = HNSWIndex("l2", dim=16, m=8, ef_construction=60)
    idx.add_items(x)
    dg, xd, sq, _, _ = idx._sync_device()
    q = jnp.asarray(x[:16])
    calls = []
    interpreted = functools.partial(hop.hop_triton, interpret=True)

    def kernel(*a, **kw):
        calls.append(1)
        return interpreted(*a, **kw)

    out = {}
    for impl in ("xla", "triton"):
        jax.clear_caches()  # compiled searches are not keyed by the choice
        with mock.patch.object(hop, "hop_impl", lambda *a, **k: impl), \
                mock.patch.object(hop, "hop_triton", kernel):
            out[impl] = search_batch(xd, dg, q, k=5, ef=32, sq_norms=sq)
    jax.clear_caches()
    assert calls, "the pinned kernel was not traced"
    np.testing.assert_array_equal(np.asarray(out["xla"].ids),
                                  np.asarray(out["triton"].ids))
    assert (np.asarray(out["xla"].ids)[:, 0] == np.arange(16)).all()
