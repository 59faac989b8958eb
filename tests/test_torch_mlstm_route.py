"""The tensor-core route of the port's ``mlstm_chunkwise``, on the CPU.

``kernels/mlstm.py::route`` on a table of (dtype, dh, chunk); the plain
mirror of the route's three passes (``ref.mlstm_chunkwise_split``: gates,
intra-chunk, inter-chunk) against the JAX package's Pallas kernel in
interpret mode and its scan form (``impl="xla"``) at ``atol = rtol =
5e-4``, as tests/test_mlstm_kernel.py holds the Pallas kernel, on that
test's shapes, dh 512 with gates x10 and T over many chunks; and the
same mirror with every matrix product emulated as the route's 3xTF32
split (round to nearest to 10 mantissa bits, as ``cvt.rna.tf32.f32``),
which must keep the same tolerance.  Inputs come from a numpy seed.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import mlstm as kmlstm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

KERNEL_TOL = 5e-4       # tests/test_mlstm_kernel.py
# b, h, t, dh, chunk, gate scale: tests/test_mlstm_kernel.py's shapes,
# dh 512 (xlstm-350m's) with gates x10, and T over many chunks
SPLIT_CASES = [
    (2, 4, 64, 16, 16, 1.0), (1, 2, 128, 32, 32, 1.0),
    (1, 1, 256, 128, 128, 1.0), (2, 2, 96, 8, 16, 1.0),
    (1, 4, 256, 512, 128, 10.0), (1, 2, 1024, 32, 64, 1.0),
    (1, 2, 768, 64, 128, 10.0),
]


def _inputs(b, h, t, dh, gate_scale, seed):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, h, t, dh)) * dh ** -0.5).astype(np.float32)
    k = (rng.normal(size=(b, h, t, dh)) * dh ** -0.5).astype(np.float32)
    v = rng.normal(size=(b, h, t, dh)).astype(np.float32)
    ip = (rng.normal(size=(b, h, t)) * gate_scale).astype(np.float32)
    fp = ((rng.normal(size=(b, h, t)) + 1.0) * gate_scale).astype(np.float32)
    return q, k, v, ip, fp


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("dtype,dh,chunk,want", [
    (torch.float32, 512, 128, "tc"),      # xlstm-350m's prefill
    (torch.float32, 32, 128, "tc"),       # the reduced xlstm
    (torch.bfloat16, 512, 128, "tc"),
    (torch.float32, 256, 64, "tc"),
    (torch.float32, 64, 64, "tc"),
    (torch.bfloat16, 32, 64, "tc"),
    (torch.float32, 96, 128, "tc"),
    (torch.float32, 16, 16, "fma"),       # chunk 16
    (torch.float32, 32, 32, "fma"),       # chunk 32
    (torch.float32, 48, 100, "fma"),      # chunk 100, dh 48
    (torch.float32, 16, 1, "fma"),        # chunk 1
    (torch.float32, 80, 128, "fma"),      # dh not a multiple of 32
    (torch.float32, 16, 128, "fma"),      # dh below 32
    (torch.float32, 544, 128, "fma"),     # dh above 512
    (torch.float16, 512, 128, "fma"),     # neither f32 nor bf16
])
def test_route(dtype, dh, chunk, want):
    assert kmlstm.route(dtype, dh, chunk) == want


@pytest.mark.parametrize("b,h,t,dh,chunk,gsc", SPLIT_CASES)
def test_split_mirror_vs_jax(b, h, t, dh, chunk, gsc):
    """The three passes, in f32, against the Pallas kernel (interpret
    mode) and the scan form."""
    arrs = _inputs(b, h, t, dh, gsc, t * 11 + dh)
    got = ref.mlstm_chunkwise_split(*map(torch.from_numpy, arrs),
                                    chunk=chunk)
    assert [tuple(g.shape) for g in got] == [
        (b, h, t, dh), (b, h, dh, dh), (b, h, dh), (b, h)]
    for g in got:
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
    for impl in ("interpret", "xla"):
        want = jops.mlstm(*map(jnp.asarray, arrs), chunk=chunk, impl=impl)
        _close(got, want, KERNEL_TOL)


@pytest.mark.parametrize("b,h,t,dh,chunk,gsc", [
    (1, 4, 256, 512, 128, 10.0), (1, 2, 256, 32, 128, 1.0),
    (1, 2, 512, 64, 64, 10.0)])
def test_split_mirror_3xtf32_keeps_f32_tolerance(b, h, t, dh, chunk, gsc):
    """Every product as hi hi + hi lo + lo hi of tf32 halves: within
    the f32 check of the Pallas kernel in interpret mode."""
    arrs = _inputs(b, h, t, dh, gsc, 5 * t + dh)
    got = ref.mlstm_chunkwise_split(*map(torch.from_numpy, arrs),
                                    chunk=chunk, matmul=ref.matmul_3xtf32)
    want = jops.mlstm(*map(jnp.asarray, arrs), chunk=chunk,
                      impl="interpret")
    _close(got, want, KERNEL_TOL)


def test_tf32_round_is_cvt_rna():
    """Ten mantissa bits, to nearest, ties away from zero."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0 + ulp / 2, 1.0 + ulp / 2 - 2 ** -23,
                      -(1.0 + ulp / 2), 1.0 + 3 * ulp / 2, 3.0, 0.0],
                     dtype=torch.float32)
    want = [1.0 + ulp, 1.0, -(1.0 + ulp), 1.0 + 2 * ulp, 3.0, 0.0]
    assert ref.tf32_round(x).tolist() == want


def test_matmul_3xtf32_error_is_f32_sized():
    """The split's product stays within a few f32 ulps of the f32
    product where one tf32 product is three orders of magnitude off."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(64, 256)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(256, 64)).astype(np.float32))
    exact = (a.double() @ b.double())
    err3 = float((ref.matmul_3xtf32(a, b).double() - exact).abs().max())
    err1 = float((ref.tf32_round(a) @ ref.tf32_round(b)
                  ).double().sub(exact).abs().max())
    err32 = float(((a @ b).double() - exact).abs().max())
    assert err3 < 4 * err32 + 1e-6
    assert err1 > 100 * err3
