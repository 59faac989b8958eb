"""The "scan" route of the port's ``rglru_scan``, on the CPU.

``kernels/rglru.py::route`` on a table of (T, dtype); and the plain
mirror of the route's association (``ref.rglru_chunked``: chunks of 64
or 128 rows, four sub-chunks each, every chunk's start state from the
look-back) against the JAX package's sequential oracle
(``repro.kernels.ref.rglru``) and its associative scan
(``ops.rglru(impl="xla")``) at ``atol = rtol = 2e-5``, as
tests/test_kernels.py holds the Pallas kernel, with an f64 loop beside
them, which all three must meet at the same tolerance, so that a gap
between two of them shows whose it is.  The look-back is mirrored at
both ends: every chunk finding the prefix of the chunk before, and
every chunk folding the aggregates of all chunks before it down to
chunk 0.  Cases: T = 8192 at a narrow D, a in [0.999, 1), rows with
a = 1 exactly and a = 1 throughout, ragged last chunks, with and
without h0.  The Pallas kernel's interpret mode fails under the
installed jax, so it is not run here.  Inputs come from a numpy seed.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rglru as krglru  # noqa: E402

RGLRU_TOL = 2e-5        # tests/test_kernels.py
BF16_TOL = 1e-2
# b, t, d, low and high end of a, h0, chunk; two shapes only, since
# each new shape compiles JAX's scan anew
CASES = [
    (1, 8192, 16, 0.9, 0.999, False, 64),     # recurrentgemma's T, narrow
    (1, 8192, 16, 0.9, 0.999, True, 128),
    (1, 8192, 16, 0.999, 1.0, True, 64),      # a next to 1
    (1, 8192, 16, 0.999, 1.0, False, 128),
    (2, 1000, 40, 0.5, 0.999, True, 64),      # ragged last chunk (40 rows)
    (2, 1000, 40, 0.5, 0.999, False, 128),    # (104 rows)
    (2, 1000, 40, 0.0, 1.0, True, 64),        # a from 0 to 1
    (2, 1000, 40, 1.0, 1.0, True, 128),       # a = 1 throughout
]


def _inputs(b, t, d, lo, hi, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    a = rng.uniform(lo, hi, size=(b, t, d)).astype(np.float32)
    a[:, ::7] = 1.0                                  # a = 1 exactly
    g = rng.uniform(0.0, 1.0, size=(b, t, d)).astype(np.float32)
    h0 = rng.normal(size=(b, d)).astype(np.float32)
    return x, a, g, h0


def _f64_loop(x, a, g, h0):
    x, a, g = (v.astype(np.float64) for v in (x, a, g))
    inp = np.sqrt(np.maximum(1.0 - a * a, 0.0)) * (g * x)
    h = np.zeros((x.shape[0], x.shape[2])) if h0 is None else h0.astype(
        np.float64)
    ys = np.empty_like(x)
    for t in range(x.shape[1]):
        h = a[:, t] * h + inp[:, t]
        ys[:, t] = h
    return ys, h


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=tol, err_msg=what)


@pytest.mark.parametrize("t,dtype,want", [
    (8192, torch.bfloat16, "scan"),     # recurrentgemma-2b's prefill
    (8192, torch.float32, "scan"),
    (1, torch.bfloat16, "seq"),         # decode
    (1, torch.float32, "seq"),
    (40, torch.float32, "seq"),         # the reduced configs' prompts
    (255, torch.bfloat16, "seq"),       # just under the threshold
    (256, torch.bfloat16, "scan"),      # at it
    (256, torch.float32, "scan"),
    (8192, torch.float16, "seq"),       # neither f32 nor bf16
])
def test_route(t, dtype, want):
    assert krglru.route(t, dtype) == want


def test_route_threshold_is_whole_chunks():
    t = krglru.SCAN_MIN_CHUNKS * krglru.SCAN_CHUNK
    assert krglru.route(t - 1, torch.float32) == "seq"
    assert krglru.route(t, torch.float32) == "scan"


@pytest.mark.parametrize("lookback", [1, 10 ** 6])
@pytest.mark.parametrize("b,t,d,lo,hi,with_h0,chunk", CASES)
def test_chunked_association_vs_jax(b, t, d, lo, hi, with_h0, chunk,
                                    lookback):
    x, a, g, h0 = _inputs(b, t, d, lo, hi, seed=t + 7 * d + chunk)
    h0 = h0 if with_h0 else None
    y64, h64 = _f64_loop(x, a, g, h0)
    got = ref.rglru_chunked(*map(torch.from_numpy, (x, a, g)),
                            None if h0 is None else torch.from_numpy(h0),
                            chunk=chunk, lookback=lookback)
    jargs = tuple(map(jnp.asarray, (x, a, g)))
    jh = None if h0 is None else jnp.asarray(h0)
    wants = {"ref.rglru": jref.rglru(*jargs, jh),
             "ops.rglru(xla)": jops.rglru(*jargs, jh, impl="xla")}
    assert got[0].shape == (b, t, d) and got[0].dtype == torch.float32
    assert got[1].shape == (b, d) and got[1].dtype == torch.float32
    for name, (y, h) in {"mirror": (got[0].numpy(), got[1].numpy()),
                         **wants}.items():
        _close(y, y64, RGLRU_TOL, f"{name} y vs the f64 loop")
        _close(h, h64, RGLRU_TOL, f"{name} h_T vs the f64 loop")
    for name, (y, h) in wants.items():
        _close(got[0].numpy(), y, RGLRU_TOL, f"mirror y vs {name}")
        _close(got[1].numpy(), h, RGLRU_TOL, f"mirror h_T vs {name}")


@pytest.mark.parametrize("chunk", [64, 128])
def test_chunked_association_bf16_vs_jax(chunk):
    """bf16 inputs, f32 arithmetic, y rounded to bf16 as the kernel
    writes it; h_T stays f32."""
    x, a, g, h0 = _inputs(2, 1000, 72, 0.9, 0.999, seed=chunk)
    xb, ab, gb = (torch.from_numpy(v).bfloat16() for v in (x, a, g))
    y, h = ref.rglru_chunked(xb, ab, gb, torch.from_numpy(h0), chunk=chunk)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    jargs = tuple(jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
                  for v in (xb, ab, gb))
    jy, jh = jref.rglru(*jargs, jnp.asarray(h0))
    _close(y.float().numpy(), np.asarray(jy, np.float32), BF16_TOL, "y")
    _close(h.numpy(), np.asarray(jh), RGLRU_TOL, "h_T")


def test_mirror_matches_the_sequential_loop_on_short_t():
    """One chunk, one row a sub-chunk and less: the association is the
    sequential loop's own, to the last bit."""
    x, a, g, h0 = _inputs(2, 3, 5, 0.5, 0.999, seed=1)
    args = tuple(map(torch.from_numpy, (x, a, g, h0)))
    y, h = ref.rglru_chunked(*args, chunk=64)
    yr, hr = ref.rglru(*args)
    assert torch.equal(y, yr) and torch.equal(h, hr)
