"""The port's data plane (``repro_torch.core.chunking`` and
``repro_torch.core.aggregation``) against the JAX package's, on the CPU.

Chunking is exact: flatten, pack, unpack and unflatten give the JAX
package's values and dtypes on a mixed-dtype tree (bf16 and f32
leaves, a 0-d leaf, a ragged last chunk), and a torrent descriptor
built from the same values has the same ``desc_id`` and chunk hashes.
Aggregation is held at atol = rtol = 2e-5: both paths of
``fedavg_flat`` (JAX's ``use_kernel=True`` runs its Pallas kernel in
interpret mode; the port's runs the plain version of its CUDA kernel
on CPU tensors), ``fedavg_pytree``, ``per_client_aggregates`` and
``agreement_check``, with zero active mass and a masked NaN row.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import aggregation as jagg                     # noqa: E402
from repro.core import chunking as jchunk                      # noqa: E402

from repro_torch.core import aggregation as tagg               # noqa: E402
from repro_torch.core import chunking as tchunk                # noqa: E402
from repro_torch.tree import leaves as tleaves                 # noqa: E402

TOL = 2e-5


def _trees(seed: int):
    """The same mixed-dtype update tree for both packages, from numpy:
    a bf16 matrix, an f32 vector, a 0-d leaf, a nested list and tuple,
    a dict whose keys are not in sorted order."""
    rng = np.random.default_rng(seed)
    arrays = {"w": rng.standard_normal((7, 5)).astype(np.float32),
              "b": rng.standard_normal(9).astype(np.float32),
              "s": np.float32(rng.standard_normal()),
              "l0": rng.standard_normal((2, 3)).astype(np.float32),
              "l1": rng.standard_normal(4).astype(np.float32)}
    bf16 = {"w", "l1"}

    def build(conv):
        c = {k: conv(v, k in bf16) for k, v in arrays.items()}
        return {"z": c["w"], "a": c["b"], "m": c["s"],
                "nested": [c["l0"], (c["l1"],)]}

    jt = build(lambda v, h: jnp.asarray(v).astype(jnp.bfloat16 if h
                                                  else jnp.float32))
    tt = build(lambda v, h: torch.from_numpy(np.array(v)).to(
        torch.bfloat16 if h else torch.float32))
    return jt, tt


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def jax_leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# chunking: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk_bytes", [4, 12, 64, 4096])
def test_pack_unpack_flatten_equal_to_jax(chunk_bytes):
    jt, tt = _trees(0)
    jflat, (jdef, jspec) = jchunk.flatten_update(jt)
    tflat, (tdef, tspec) = tchunk.flatten_update(tt)
    np.testing.assert_array_equal(np.asarray(jflat), tflat.numpy())
    assert [(tuple(s), _name(d)) for s, d in jspec] == \
        [(s, _name(d)) for s, d in tspec]
    jc = jchunk.pack_chunks(jflat, chunk_bytes)
    tc = tchunk.pack_chunks(tflat, chunk_bytes)
    assert tc.dtype == torch.float32 and tuple(tc.shape) == jc.shape
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    d = tflat.shape[0]
    assert (jchunk.chunk_count(d * 4, chunk_bytes)
            == tchunk.chunk_count(d * 4, chunk_bytes) == tc.shape[0])
    np.testing.assert_array_equal(
        np.asarray(jchunk.unpack_chunks(jc, d)),
        tchunk.unpack_chunks(tc, d).numpy())
    jback = jchunk.reassemble_update(jc, ((jdef, jspec), d))
    tback = tchunk.reassemble_update(tc, ((tdef, tspec), d))
    for jl, tl, orig in zip(jax_leaves(jback), tleaves(tback), tleaves(tt)):
        assert _name(jl.dtype) == _name(tl.dtype) == _name(orig.dtype)
        assert tuple(jl.shape) == tuple(tl.shape) == tuple(orig.shape)
        np.testing.assert_array_equal(_np(jl), _np(tl))
        assert torch.equal(tl, orig)


def test_ragged_last_chunk_is_zero_padded():
    _, tt = _trees(1)
    flat, _ = tchunk.flatten_update(tt)
    d = flat.shape[0]
    chunks = tchunk.pack_chunks(flat, 64)          # 16 values a chunk
    assert d % 16 and chunks.shape == (-(-d // 16), 16)
    assert not chunks.reshape(-1)[d:].any()


def test_pack_into_a_preallocated_stack():
    _, tt = _trees(2)
    flat, _ = tchunk.flatten_update(tt)
    d = flat.shape[0]
    buf = tchunk.alloc_chunks(3, d, 64, "cpu")
    assert buf.shape == (3, -(-d // 16), 16)
    assert not buf.reshape(3, -1)[:, d:].any()
    for v in range(3):
        out = tchunk.pack_chunks(flat * (v + 1), 64, out=buf[v])
        assert out.data_ptr() == buf[v].data_ptr()
        assert torch.equal(out, tchunk.pack_chunks(flat * (v + 1), 64))
    with pytest.raises(ValueError, match="contiguous"):
        tchunk.pack_chunks(flat, 128, out=buf[0])


def test_descriptor_equal_to_jax_and_verifies_pieces():
    jt, tt = _trees(3)
    jc, jdesc, jmeta = jchunk.make_update_torrent(jt, 17.0, 64)
    tc, tdesc, tmeta = tchunk.make_update_torrent(tt, 17.0, 64)
    # desc_id, hashes, sizes and weight
    assert dataclasses.asdict(tdesc) == dataclasses.asdict(jdesc)
    assert tmeta[1] == jmeta[1]
    for salt in (b"", b"round-4"):
        a = jchunk.TorrentDescriptor.build(np.asarray(jc), 2.5, salt)
        b = tchunk.TorrentDescriptor.build(tc, 2.5, salt)
        assert a.desc_id == b.desc_id and a.chunk_hashes == b.chunk_hashes
    for i in range(tc.shape[0]):
        assert tdesc.verify_chunk(i, tc[i])
        assert tdesc.verify_chunk(i, tc[i].numpy())
    bad = tc[1].clone()
    bad.view(torch.int32)[3] ^= 1 << 20
    assert not tdesc.verify_chunk(1, bad)
    assert not jdesc.verify_chunk(1, bad.numpy())
    assert not tdesc.verify_chunk(2, tc[1])              # the wrong slot


# ---------------------------------------------------------------------------
# aggregation: within 2e-5 of JAX
# ---------------------------------------------------------------------------

def _updates(n: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.integers(1, 50, n).astype(np.float32)
    return u, w


ACTIVE = {
    "all": lambda n: np.ones(n, np.float32),
    "some": lambda n: (np.arange(n) % 3 != 1).astype(np.float32),
    "one": lambda n: (np.arange(n) == n - 1).astype(np.float32),
    "none": lambda n: np.zeros(n, np.float32),
}


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("active", sorted(ACTIVE))
def test_fedavg_flat_equal_to_jax(active, use_kernel):
    u, w = _updates(7, 300, 4)
    a = ACTIVE[active](7)
    want = np.asarray(jagg.fedavg_flat(jnp.asarray(u), jnp.asarray(w),
                                       jnp.asarray(a), use_kernel=use_kernel))
    got = tagg.fedavg_flat(torch.from_numpy(u), w, a, use_kernel=use_kernel)
    assert got.dtype == torch.float32 and got.shape == (300,)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    if active == "none":
        assert not got.any()
    np.testing.assert_allclose(
        tagg.fedavg_weights(w, a).numpy(),
        np.asarray(jagg.fedavg_weights(jnp.asarray(w), jnp.asarray(a))),
        atol=TOL, rtol=TOL)


def test_fedavg_flat_masked_nan_row():
    """A masked client's NaN update: the einsum path is poisoned in
    both packages (0 * NaN), the kernel path selects the row out."""
    u, w = _updates(5, 64, 5)
    u[2] = np.nan
    a = np.array([1, 1, 0, 1, 1], np.float32)
    for use_kernel in (False, True):
        want = np.asarray(jagg.fedavg_flat(
            jnp.asarray(u), jnp.asarray(w), jnp.asarray(a),
            use_kernel=use_kernel))
        got = tagg.fedavg_flat(torch.from_numpy(u), w, a,
                               use_kernel=use_kernel).numpy()
        assert np.isfinite(got).all() == use_kernel
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_fedavg_flat_bf16_updates_through_the_kernel_path():
    u, w = _updates(4, 256, 6)
    a = np.array([1, 0, 1, 1], np.float32)
    want = np.asarray(jagg.fedavg_flat(jnp.asarray(u).astype(jnp.bfloat16),
                                       jnp.asarray(w), jnp.asarray(a),
                                       use_kernel=True), np.float32)
    got = tagg.fedavg_flat(torch.from_numpy(u).to(torch.bfloat16), w, a,
                           use_kernel=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2,
                               rtol=1e-2)


def test_fedavg_pytree_equal_to_jax():
    trees = [_trees(s) for s in range(4)]
    w = np.array([3.0, 1.0, 0.0, 2.0], np.float32)
    a = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    want = jagg.fedavg_pytree([j for j, _ in trees], w, a)
    got = tagg.fedavg_pytree([t for _, t in trees], w, a)
    for jl, tl in zip(jax_leaves(want), tleaves(got)):
        assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)


def test_per_client_aggregates_equal_to_jax():
    u, w = _updates(6, 200, 7)
    recon = np.random.default_rng(7).random((6, 6)) < 0.5
    np.fill_diagonal(recon, True)
    recon[4] = False                     # a peer with an empty A_v
    want = np.asarray(jagg.per_client_aggregates(jnp.asarray(u), w, recon))
    got = tagg.per_client_aggregates(torch.from_numpy(u), w, recon)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    assert not got[4].any()
    for v in range(6):                   # each row is that peer's FedAvg
        np.testing.assert_allclose(
            got[v].numpy(),
            tagg.fedavg_flat(torch.from_numpy(u), w,
                             recon[v].astype(np.float32),
                             use_kernel=True).numpy(), atol=TOL, rtol=TOL)


def test_agreement_check_equal_to_jax():
    u, w = _updates(5, 50, 8)
    full = np.ones((5, 5), bool)
    agg = np.asarray(jagg.per_client_aggregates(jnp.asarray(u), w, full))
    split = full.copy()
    split[3, 1] = False
    agg2 = np.asarray(jagg.per_client_aggregates(jnp.asarray(u), w, split))
    for arr, atol in ((agg, 0.0), (agg, 1e-6), (agg2, 1e-6), (agg2, 10.0)):
        assert (tagg.agreement_check(torch.from_numpy(arr), atol)
                == jagg.agreement_check(jnp.asarray(arr), atol))
    assert tagg.agreement_check(torch.from_numpy(agg), 0.0)
    assert not tagg.agreement_check(torch.from_numpy(agg2), 1e-6)
    jt = [_trees(0)[0], _trees(0)[0], _trees(1)[0]]
    tt = [_trees(0)[1], _trees(0)[1], _trees(1)[1]]
    assert tagg.agreement_check(tt[:2]) and not tagg.agreement_check(tt)
    assert jagg.agreement_check(jt[:2]) and not jagg.agreement_check(jt)
