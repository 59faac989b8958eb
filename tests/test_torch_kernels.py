"""The port's kernel package against the JAX package's kernels.

Inputs come from a numpy seed and go through both packages: the port's
plain versions (``repro_torch.kernels.ref`` / ``ops``) and its CUDA
wrappers on CPU tensors (which run the plain versions) are held
against ``repro.kernels.ref`` and the Pallas kernels in interpret
mode (rglru against ``ref.rglru`` and the XLA scan: its interpret
kernel does not run under jax 0.9.0; the mlstm is held against JAX in
tests/test_torch_xlstm.py).  Tolerances follow
tests/test_kernels.py: fedavg ``atol=rtol=2e-5``, attention ``3e-5``,
rglru ``2e-5``, int8 codes and scales exact, dequantized values exact.  Tests marked ``cuda`` build and launch the
CUDA kernels and skip where there is no GPU.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import LAUNCHES, _build, fedavg, quantize  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

FEDAVG_TOL = 2e-5
ATTN_TOL = 3e-5


def _fedavg_inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, d)).astype(np.float32)
    w = (rng.uniform(size=n) * 10).astype(np.float32)
    m = (rng.uniform(size=n) > 0.3).astype(np.float32)
    m[0] = 1.0
    return u, w, m


# ----------------------------------------------------------------------
# FedAvg reduction
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n,d,bd", [
    (10, 5000, 512), (37, 1234, 256), (100, 65536, 2048), (3, 8, 8),
])
def test_fedavg_vs_jax(n, d, bd):
    u, w, m = _fedavg_inputs(n, d, n)
    want = np.asarray(jref.fedavg_reduce(jnp.asarray(u), jnp.asarray(w),
                                         jnp.asarray(m)))
    interp = np.asarray(jops.fedavg(jnp.asarray(u), jnp.asarray(w),
                                    jnp.asarray(m), impl="interpret",
                                    block_d=bd))
    tu, tw, tm = map(torch.from_numpy, (u, w, m))
    for impl in ("torch", "ref", "cuda"):
        got = ops.fedavg(tu, tw, tm, impl=impl).numpy()
        np.testing.assert_allclose(got, want, atol=FEDAVG_TOL,
                                   rtol=FEDAVG_TOL)
        np.testing.assert_allclose(got, interp, atol=FEDAVG_TOL,
                                   rtol=FEDAVG_TOL)


@pytest.mark.parametrize("case", ["zero_mass", "zero_weights",
                                  "masked_nan_row", "single_active"])
def test_fedavg_edge_cases_vs_jax(case):
    u = np.random.default_rng(0).normal(size=(4, 96)).astype(np.float32)
    w = np.array([1., 2., 3., 4.], np.float32)
    m = np.ones(4, np.float32)
    if case == "zero_mass":
        m[:] = 0.0
    elif case == "zero_weights":
        w[:] = 0.0
    elif case == "masked_nan_row":
        u[2] = np.nan
        m[2] = 0.0
    else:
        m[:] = [0., 1., 0., 0.]
    want = np.asarray(jref.fedavg_reduce(jnp.asarray(u), jnp.asarray(w),
                                         jnp.asarray(m)))
    interp = np.asarray(jops.fedavg(jnp.asarray(u), jnp.asarray(w),
                                    jnp.asarray(m), impl="interpret",
                                    block_d=32))
    got = fedavg.fedavg_reduce(torch.from_numpy(u), torch.from_numpy(w),
                               torch.from_numpy(m)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=FEDAVG_TOL, rtol=FEDAVG_TOL)
    np.testing.assert_allclose(got, interp, atol=FEDAVG_TOL,
                               rtol=FEDAVG_TOL)
    if case in ("zero_mass", "zero_weights"):
        np.testing.assert_array_equal(got, 0.0)
    if case == "single_active":
        np.testing.assert_allclose(got, u[1], atol=1e-6)


def test_masked_normalized_weights_vs_jax():
    from repro.kernels.fedavg import masked_normalized_weights as jmnw
    rng = np.random.default_rng(5)
    for _ in range(5):
        w = (rng.uniform(size=7) * 4).astype(np.float32)
        a = (rng.uniform(size=7) > 0.5).astype(np.float32)
        np.testing.assert_allclose(
            ref.masked_normalized_weights(torch.from_numpy(w),
                                          torch.from_numpy(a)).numpy(),
            np.asarray(jmnw(jnp.asarray(w), jnp.asarray(a))),
            rtol=1e-6, atol=0)   # f32 sums of 7 terms, in any order


def test_fedavg_bf16_updates_keep_dtype():
    u, w, m = _fedavg_inputs(5, 300, 1)
    want = np.asarray(jref.fedavg_reduce(jnp.asarray(u, jnp.bfloat16),
                                         jnp.asarray(w), jnp.asarray(m)
                                         ).astype(jnp.float32))
    got = fedavg.fedavg_reduce(torch.from_numpy(u).bfloat16(),
                               torch.from_numpy(w), torch.from_numpy(m))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2,
                               rtol=1e-2)


# ----------------------------------------------------------------------
# Chunk quantization
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n,e", [(7, 512 * 128), (1, 128), (16, 1024),
                                 (3, 2047)])
def test_quantize_codes_and_scales_exact_vs_jax(n, e):
    x = (np.random.default_rng(e).normal(size=(n, e)) * 5).astype(
        np.float32)
    q1, s1 = jref.chunk_quantize(jnp.asarray(x))
    q2, s2 = jops.quantize(jnp.asarray(x), impl="interpret")
    tx = torch.from_numpy(x)
    for impl in ("torch", "cuda"):
        q, s = ops.quantize(tx, impl=impl)
        assert q.dtype == torch.int8 and s.shape == (n, 1)
        np.testing.assert_array_equal(q.numpy(), np.asarray(q1))
        np.testing.assert_array_equal(q.numpy(), np.asarray(q2))
        np.testing.assert_array_equal(s.numpy(), np.asarray(s1))
        # The interpret kernel's `amax / 127.0` lowers through XLA as a
        # multiply by the reciprocal, one ulp off the oracle's division
        # on some rows; tests/test_kernels.py compares those two scales
        # at atol=1e-7 too.
        np.testing.assert_allclose(s.numpy(), np.asarray(s2), atol=1e-7,
                                   rtol=0)
        d = ops.dequantize(q, s, impl=impl).numpy()
        np.testing.assert_array_equal(
            d, np.asarray(jref.chunk_dequantize(q1, s1)))
        np.testing.assert_array_equal(
            d, np.asarray(jops.dequantize(q1, s1, impl="interpret")))
        assert np.abs(d - x).max() / np.abs(x).max() < 0.01


@pytest.mark.parametrize("case", ["zero_chunk", "ties", "negative_amax"])
def test_quantize_edge_cases_exact_vs_jax(case):
    if case == "zero_chunk":
        x = np.zeros((2, 256), np.float32)
    elif case == "ties":
        # amax 127 -> scale 1: the .5 values round half to even
        x = np.array([[127., 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]],
                     np.float32)
    else:
        x = np.array([[-3.0, 1.0, 2.9999, -0.001]], np.float32)
    q1, s1 = jref.chunk_quantize(jnp.asarray(x))
    q, s = quantize.chunk_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q1))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s1))
    if case == "zero_chunk":
        assert (q.numpy() == 0).all() and (s.numpy() == 1.0).all()
        d = quantize.chunk_dequantize(q, s)
        assert (d.numpy() == 0).all()
    if case == "ties":
        assert q[0].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]


def test_dequantize_dtype_and_out_buffer():
    x = np.random.default_rng(3).normal(size=(4, 100)).astype(np.float32)
    q1, s1 = jref.chunk_quantize(jnp.asarray(x))
    q, s = quantize.chunk_quantize(torch.from_numpy(x))
    bf = quantize.chunk_dequantize(q, s, dtype=torch.bfloat16)
    want = np.asarray(jops.dequantize(q1, s1, impl="interpret",
                                      dtype=jnp.bfloat16).astype(jnp.float32))
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf.float().numpy(), want)
    buf = torch.from_numpy(x.copy())
    out = quantize.chunk_dequantize(q, s, out=buf)
    assert out.data_ptr() == buf.data_ptr()
    np.testing.assert_array_equal(
        buf.numpy(), np.asarray(jref.chunk_dequantize(q1, s1)))


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    before = dict(LAUNCHES)
    u, w, m = _fedavg_inputs(3, 50, 2)
    fedavg.fedavg_reduce(torch.from_numpy(u), w, m)
    q, s = quantize.chunk_quantize(torch.from_numpy(u))
    quantize.chunk_dequantize(q, s)
    assert dict(LAUNCHES) == before


@pytest.mark.cuda
@pytest.mark.parametrize("n,e", [(1, 1), (8, 430_143_744), (3, 2047),
                                 (70_000, 65_536)])
def test_quantize_grid_tiles(n, e):
    if not torch.cuda.is_available():
        pytest.skip("the tile count comes from the built CUDA extension")
    tiles = _build.extension().chunk_tiles(n, e)
    assert 1 <= tiles <= -(-e // 256)
    assert tiles < 2 ** 31
    assert tiles * min(n, 65535) <= max(8192, min(n, 65535))


def test_require_cuda_rejects_cpu_and_mixed_devices():
    with pytest.raises(ValueError, match="CUDA"):
        _build.require_cuda("k", torch.zeros(2))


# ----------------------------------------------------------------------
# Attention: the plain path the models run
# ----------------------------------------------------------------------

ATTN_CASES = [
    # b, hq, hkv, tq, tk, d, causal, window, softcap, q_off, kv_off
    (2, 4, 2, 128, 128, 64, True, None, None, 0, 0),
    (1, 8, 4, 256, 256, 128, True, 64, None, 0, 0),
    (1, 2, 2, 100, 100, 32, True, None, 50.0, 0, 0),
    (2, 4, 1, 1, 320, 64, True, None, None, 319, 0),     # decode
    (1, 4, 4, 1, 64, 32, True, 64, None, 100, 37),       # rolling decode
    (1, 4, 4, 128, 256, 64, False, None, None, 0, 0),    # encoder
    (1, 2, 1, 96, 96, 16, True, 32, 30.0, 0, 0),         # all features
]


@pytest.mark.parametrize(
    "b,hq,hkv,tq,tk,d,causal,window,softcap,qoff,kvoff", ATTN_CASES)
def test_attention_torch_vs_jax_xla(b, hq, hkv, tq, tk, d, causal, window,
                                    softcap, qoff, kvoff):
    rng = np.random.default_rng(b * 31 + tq)
    q = rng.normal(size=(b, hq, tq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, tk, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, tk, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff,
              kv_offset=kvoff)
    want = np.asarray(jops.attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), impl="xla",
                                     block_q=64, **kw))
    tq_, tk_, tv_ = map(torch.from_numpy, (q, k, v))
    got = ops.attention(tq_, tk_, tv_, impl="torch", block_q=64, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_TOL,
                               rtol=ATTN_TOL)
    # the port's oracle against the plain path it checks
    oracle = ops.attention(tq_, tk_, tv_, impl="ref", **kw)
    np.testing.assert_allclose(oracle.numpy(), got.numpy(), atol=ATTN_TOL,
                               rtol=ATTN_TOL)


def test_attention_oracle_vs_jax_oracle():
    rng = np.random.default_rng(8)
    q = rng.normal(size=(1, 4, 40, 16)).astype(np.float32)
    k = rng.normal(size=(1, 2, 40, 16)).astype(np.float32)
    kw = dict(causal=True, window=8, softcap=20.0)
    want = jref.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), **kw)
    got = ref.mha(torch.from_numpy(q), torch.from_numpy(k),
                  torch.from_numpy(k), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATTN_TOL, rtol=ATTN_TOL)


def test_attention_torch_is_differentiable():
    q = torch.randn(1, 2, 32, 16, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    ops.attention(q, q, q, impl="torch", block_q=8).sum().backward()
    assert q.grad.shape == q.shape and bool(torch.isfinite(q.grad).all())


@pytest.mark.parametrize("call", ["mlstm", "bad_impl"])
def test_unported_impls_raise(call):
    x = torch.zeros(1, 1, 4, 8)
    if call == "mlstm":
        # the kernel path has no gradient, as the Pallas kernel has none
        q = torch.rand(1, 1, 4, 8, requires_grad=True)
        g = torch.zeros(1, 1, 4)
        h, *_ = ops.mlstm(q, q, q, g, g, chunk=4, impl="cuda")
        with pytest.raises(RuntimeError, match="no gradient"):
            h.sum().backward()
        h, *_ = ops.mlstm(q, q, q, g, g, chunk=4, impl="torch")
        h.sum().backward()
        assert q.grad is not None and bool(torch.isfinite(q.grad).all())
    else:
        with pytest.raises(ValueError):
            ops.fedavg(x[0, 0], torch.ones(4), torch.ones(4), impl="pallas")


@pytest.mark.parametrize("call", ["attention_cuda", "rglru", "mlstm"])
def test_cpu_tensors_take_the_plain_kernel_versions(call):
    """The kernel wrappers run their plain versions for CPU tensors and
    count no launch."""
    before = dict(LAUNCHES)
    gen = torch.Generator().manual_seed(1)
    if call == "attention_cuda":
        q = torch.randn(1, 4, 20, 16, generator=gen)
        k = torch.randn(1, 2, 20, 16, generator=gen)
        kw = dict(window=8, softcap=30.0, q_offset=3, kv_offset=-2)
        got = ops.attention(q, k, k, impl="cuda", **kw)
        want = ref.attention_qchunk(q, k, k, **kw)
    elif call == "rglru":
        x, a, g = (torch.rand(2, 9, 5, generator=gen) for _ in range(3))
        h0 = torch.randn(2, 5, generator=gen)
        got = ops.rglru(x, a, g, h0, impl="cuda")
        want = ref.rglru(x, a, g, h0)
    else:
        qkv = [torch.randn(2, 3, 24, 8, generator=gen) for _ in range(3)]
        i, f = (torch.randn(2, 3, 24, generator=gen) for _ in range(2))
        got = ops.mlstm(*qkv, i, f, chunk=8, impl="cuda")
        want = ref.mlstm_chunkwise(*qkv, i, f, chunk=8)
    for a_, b_ in zip(torch.utils._pytree.tree_leaves(got),
                      torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(a_, b_)
    assert dict(LAUNCHES) == before


# ----------------------------------------------------------------------
# The serving kernels on the CPU: flash_attention and rglru_scan
# ----------------------------------------------------------------------

def _attn_case_inputs(b, hq, hkv, tq, tk, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, tq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, tk, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, tk, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize(
    "b,hq,hkv,tq,tk,d,causal,window,softcap,qoff,kvoff", ATTN_CASES)
def test_flash_attention_cuda_impl_vs_jax_interpret(
        b, hq, hkv, tq, tk, d, causal, window, softcap, qoff, kvoff):
    """``attention(impl="cuda")`` on CPU tensors (the plain version)
    against the Pallas kernel in interpret mode."""
    q, k, v = _attn_case_inputs(b, hq, hkv, tq, tk, d, b * 17 + tk)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff,
              kv_offset=kvoff)
    want = np.asarray(jops.attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), impl="interpret",
                                     block_q=64, block_k=64, **kw))
    got = ops.attention(*map(torch.from_numpy, (q, k, v)), impl="cuda",
                        block_q=64, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_TOL,
                               rtol=ATTN_TOL)


@pytest.mark.parametrize("case", [ATTN_CASES[1], ATTN_CASES[4],
                                  ATTN_CASES[6]])
def test_attention_cuda_grad_vs_jax(case):
    """The kernel path's backward recomputes through the plain path, as
    JAX's custom_vjp recomputes through the XLA path."""
    b, hq, hkv, tq, tk, d, causal, window, softcap, qoff, kvoff = case
    q, k, v = _attn_case_inputs(b, hq, hkv, tq, tk, d, 7)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff,
              kv_offset=kvoff)
    want = jax.grad(lambda q_, k_, v_: jnp.sum(jops.attention(
        q_, k_, v_, impl="xla", block_q=64, **kw) ** 2),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    req = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = ops.attention(*req, impl="cuda", block_q=64, **kw)
    got = torch.autograd.grad((out ** 2).sum(), req)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATTN_TOL,
                                   rtol=ATTN_TOL)


RGLRU_TOL = 2e-5


@pytest.mark.parametrize("b,t,d", [(2, 128, 64), (1, 300, 100),
                                   (3, 64, 512), (1, 17, 9)])
def test_rglru_vs_jax(b, t, d):
    """Every impl of ``ops.rglru`` against JAX's oracle and XLA scan
    (not its interpret kernel, which jax 0.9.0 cannot run)."""
    rng = np.random.default_rng(t)
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    a = rng.uniform(0.5, 0.999, size=(b, t, d)).astype(np.float32)
    g = rng.uniform(size=(b, t, d)).astype(np.float32)
    h0 = rng.normal(size=(b, d)).astype(np.float32)
    for h in (None, h0):
        jargs = [jnp.asarray(z) for z in (x, a, g)]
        jh = None if h is None else jnp.asarray(h)
        wants = [jref.rglru(*jargs, jh), jops.rglru(*jargs, jh, impl="xla")]
        targs = [torch.from_numpy(z) for z in (x, a, g)]
        th = None if h is None else torch.from_numpy(h)
        for impl in ("torch", "ref", "cuda"):
            y, ht = ops.rglru(*targs, th, impl=impl)
            assert y.dtype == torch.float32 and ht.shape == (b, d)
            for wy, wh in wants:
                np.testing.assert_allclose(y.numpy(), np.asarray(wy),
                                           atol=RGLRU_TOL, rtol=RGLRU_TOL)
                np.testing.assert_allclose(ht.numpy(), np.asarray(wh),
                                           atol=RGLRU_TOL, rtol=RGLRU_TOL)


def test_rglru_kernel_path_raises_for_gradients():
    x = torch.rand(1, 4, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.rglru(x, x.detach(), x.detach(), impl="cuda")
    y, _ = ops.rglru(x, x.detach(), x.detach(), impl="torch")
    y.sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    with torch.no_grad():
        ops.rglru(x, x, x, impl="cuda")


# ----------------------------------------------------------------------
# On the card: the CUDA kernels against their plain versions
# ----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1, 1), (3, 2047), (7, 2 ** 20 + 3)])
def test_cuda_kernels_match_plain_versions(n, d):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    u, w, m = _fedavg_inputs(n, d, 9)
    cu, cw, cm = (torch.from_numpy(a).cuda() for a in (u, w, m))
    got = fedavg.fedavg_reduce(cu, cw, cm)
    torch.testing.assert_close(got, ref.fedavg_reduce(cu, cw, cm),
                               atol=FEDAVG_TOL, rtol=FEDAVG_TOL)
    q, s = quantize.chunk_quantize(cu * 5)
    qr, sr = ref.chunk_quantize(cu * 5)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(quantize.chunk_dequantize(q, s),
                       ref.chunk_dequantize(q, s))


# the kernel's routes beyond ATTN_CASES: bf16 wgmma prefill at D 64, 128
# and 256 with ragged Tq and Tk, window, softcap and q_offset; split-KV
# decode with group 10 over many splits, Tq 3 over a rolling cache with
# negative key positions, a row with no live key, no live key at all,
# and D 80 with group 16
ROUTE_CASES = [
    (2, 4, 2, 200, 333, 64, True, 100, 50.0, 133, 0),
    (1, 8, 4, 200, 333, 128, True, 150, 30.0, 133, 0),
    (2, 8, 4, 200, 333, 256, True, 96, 50.0, 133, 0),
    (2, 10, 1, 1, 2048, 256, True, 2048, None, 2999, 952),
    (1, 10, 1, 3, 2048, 128, True, 2048, 50.0, 1000, -1047),
    (2, 8, 4, 3, 300, 64, True, None, None, 0, 1),
    (1, 4, 2, 1, 100, 32, True, None, None, 0, 5),
    (1, 16, 1, 4, 1000, 80, True, None, 30.0, 996, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", ATTN_TOL),
                                       ("bfloat16", 1e-2)])
@pytest.mark.parametrize(
    "b,hq,hkv,tq,tk,d,causal,window,softcap,qoff,kvoff",
    ATTN_CASES + ROUTE_CASES)
def test_cuda_flash_attention_matches_plain_version(
        b, hq, hkv, tq, tk, d, causal, window, softcap, qoff, kvoff, dtype,
        tol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    q, k, v = (torch.from_numpy(a).cuda().to(getattr(torch, dtype))
               for a in _attn_case_inputs(b, hq, hkv, tq, tk, d, 3))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff,
              kv_offset=kvoff)
    before = LAUNCHES["flash_attention"]
    got = ops.attention(q, k, v, impl="cuda", **kw)
    assert LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == q.dtype
    torch.testing.assert_close(got.float(),
                               ref.attention_qchunk(q, k, v, **kw).float(),
                               atol=tol, rtol=tol)


# the seq route's shapes, then the scan route's: T just under and at its
# threshold, ragged last chunks with ragged D, D of 9 (rows not whole
# 16-byte vectors) and many chunks
RGLRU_CUDA_CASES = [(2, 128, 64), (1, 17, 9), (4, 1, 2560), (2, 255, 72),
                    (2, 256, 72), (2, 1000, 200), (3, 777, 9),
                    (1, 2048, 136)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d", RGLRU_CUDA_CASES)
def test_cuda_rglru_scan_matches_plain_version(b, t, d):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, g = (torch.rand((b, t, d), generator=gen, device="cuda")
            for _ in range(2))
    a = 0.5 + 0.49 * torch.rand((b, t, d), generator=gen, device="cuda")
    a[:, ::5] = 1.0
    h0 = torch.randn((b, d), generator=gen, device="cuda")
    for h in (None, h0):
        before = LAUNCHES["rglru_scan"]
        y, ht = ops.rglru(x, a, g, h, impl="cuda")
        assert LAUNCHES["rglru_scan"] == before + 1
        yr, hr = ref.rglru(x, a, g, h)
        torch.testing.assert_close(y, yr, atol=RGLRU_TOL, rtol=RGLRU_TOL)
        torch.testing.assert_close(ht, hr, atol=RGLRU_TOL, rtol=RGLRU_TOL)
