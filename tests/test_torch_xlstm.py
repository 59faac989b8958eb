"""The port's xLSTM pieces against the JAX package's, on the CPU.

The chunkwise mLSTM (``ops.mlstm``) against JAX's scan form
(``impl="xla"``, ``atol = rtol = 2e-5``) and against its Pallas kernel
run in interpret mode (``5e-4``, bf16 ``3e-2``, as
tests/test_mlstm_kernel.py holds the kernel), on that test's shapes
plus a T that pads; the mLSTM and sLSTM cell steps; a reduced
xlstm-350m prefill whose prompt pads the last chunk, then decode steps
(``atol = 1e-5, rtol = 1e-4``); and the recomputation paths (per-chunk
checkpointing in the mLSTM, the chunked sLSTM scan, per-layer remat),
which must leave values and gradients bit-equal.  Inputs come from a
numpy seed; JAX-initialised weights are carried with
``repro_torch.interop``.  The test marked ``cuda`` launches the kernel
and skips where there is no GPU.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.dist.fl_step import make_fl_train_step as jmake_step  # noqa: E402
from repro.dist.fl_step import make_serve_step as jmake_serve  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist.fl_step import make_fl_train_step  # noqa: E402
from repro_torch.dist.fl_step import make_serve_step  # noqa: E402
from repro_torch.kernels import LAUNCHES, ops, ref  # noqa: E402
from repro_torch.kernels import mlstm as kmlstm  # noqa: E402
from repro_torch.models import layers, prefill, train_loss  # noqa: E402
from repro_torch.optim import schedules  # noqa: E402
from repro_torch.tree import flatten, leaves, tree_map, unflatten  # noqa: E402

XLA_TOL = 2e-5          # the port's plain form vs JAX's scan form
KERNEL_TOL = 5e-4       # vs the Pallas kernel (tests/test_mlstm_kernel.py)
BF16_TOL = 3e-2
ATOL, RTOL = 1e-5, 1e-4

# b, h, t, dh, chunk: tests/test_mlstm_kernel.py's shapes
KERNEL_SHAPES = [(2, 4, 64, 16, 16), (1, 2, 128, 32, 32),
                 (1, 1, 256, 128, 128), (2, 2, 96, 8, 16)]
PAD_SHAPE = (2, 3, 50, 16, 16)          # T = 50 pads to 64


def _mlstm_inputs(b, h, t, dh, seed, gate_scale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, h, t, dh)) * dh ** -0.5).astype(np.float32)
    k = (rng.normal(size=(b, h, t, dh)) * dh ** -0.5).astype(np.float32)
    v = rng.normal(size=(b, h, t, dh)).astype(np.float32)
    ip = (rng.normal(size=(b, h, t)) * gate_scale).astype(np.float32)
    fp = ((rng.normal(size=(b, h, t)) + 1.0) * gate_scale).astype(np.float32)
    return q, k, v, ip, fp


def _close(got, want, atol, rtol):
    for g, w in zip(got, want):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=atol,
                                   rtol=rtol)


# ----------------------------------------------------------------------
# The chunkwise mLSTM and the cell steps
# ----------------------------------------------------------------------

@pytest.mark.parametrize("b,h,t,dh,chunk", KERNEL_SHAPES + [PAD_SHAPE])
def test_mlstm_plain_vs_jax_xla(b, h, t, dh, chunk):
    arrs = _mlstm_inputs(b, h, t, dh, t * 13 + dh)
    want = jops.mlstm(*map(jnp.asarray, arrs), chunk=chunk, impl="xla")
    for impl in ("torch", "ref"):
        got = ops.mlstm(*map(torch.from_numpy, arrs), chunk=chunk,
                        impl=impl)
        assert [tuple(g.shape) for g in got] == [w.shape for w in want]
        assert all(g.dtype == torch.float32 for g in got)
        _close(got, want, XLA_TOL, XLA_TOL)


@pytest.mark.parametrize("gate_scale", [1.0, 10.0])
@pytest.mark.parametrize("b,h,t,dh,chunk", KERNEL_SHAPES)
def test_mlstm_vs_jax_interpret_kernel(b, h, t, dh, chunk, gate_scale):
    """The port's plain form, and ``impl="cuda"`` on CPU tensors (which
    runs it), against the Pallas kernel in interpret mode; gates scaled
    x10 make the stabiliser matter."""
    arrs = _mlstm_inputs(b, h, t, dh, t * 7 + dh, gate_scale)
    want = jops.mlstm(*map(jnp.asarray, arrs), chunk=chunk,
                      impl="interpret")
    for impl in ("torch", "cuda"):
        got = ops.mlstm(*map(torch.from_numpy, arrs), chunk=chunk,
                        impl=impl)
        for g in got:
            assert bool(torch.isfinite(g).all())
        _close(got, want, KERNEL_TOL, KERNEL_TOL)


def test_mlstm_bf16_vs_jax_interpret_kernel():
    q, k, v, ip, fp = _mlstm_inputs(1, 2, 64, 32, 0)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jops.mlstm(jq, jk, jv, jnp.asarray(ip), jnp.asarray(fp),
                      chunk=32, impl="interpret")
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = ops.mlstm(tq, tk, tv, torch.from_numpy(ip), torch.from_numpy(fp),
                    chunk=32, impl="cuda")
    assert got[0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in got[1:])
    _close(got[:1], [want[0].astype(jnp.float32)], BF16_TOL, BF16_TOL)


def test_mlstm_kernel_wrapper_checks_shapes():
    x = torch.zeros(1, 2, 48, 8)
    g = torch.zeros(1, 2, 48)
    for chunk in (0, 32, 256):       # T % chunk, or chunk out of range
        with pytest.raises(ValueError, match="chunk"):
            kmlstm.mlstm_chunkwise(x, x, x, g, g, chunk=chunk)
    with pytest.raises(ValueError, match="i_pre"):
        kmlstm.mlstm_chunkwise(x, x, x, g[:, :1], g, chunk=16)


def test_mlstm_kernel_layout_helpers():
    bthd = torch.zeros(2, 5, 3, 4)
    view = bthd.transpose(1, 2)
    assert kmlstm._dense_bhtd(view) and kmlstm._dense_bhtd(bthd)
    assert kmlstm._shared_layout(view, view)[0] is view
    mixed = kmlstm._shared_layout(view, torch.zeros(2, 3, 5, 4))
    assert all(t.is_contiguous() for t in mixed)
    assert not kmlstm._dense_bhtd(torch.zeros(2, 3, 5, 8)[..., ::2])


def test_mlstm_step_vs_jax():
    rng = np.random.default_rng(3)
    b, h, dh = 2, 3, 16
    C = rng.normal(size=(b, h, dh, dh)).astype(np.float32)
    n = rng.normal(size=(b, h, dh)).astype(np.float32)
    m = rng.normal(size=(b, h)).astype(np.float32)
    ins = [rng.normal(size=(b, h, dh)).astype(np.float32) for _ in range(3)]
    ins += [rng.normal(size=(b, h)).astype(np.float32) for _ in range(2)]
    jstate, jh = jlayers._mlstm_step(tuple(map(jnp.asarray, (C, n, m))),
                                     tuple(map(jnp.asarray, ins)))
    tstate, th = ref.mlstm_step(tuple(map(torch.from_numpy, (C, n, m))),
                                tuple(map(torch.from_numpy, ins)))
    _close([*tstate, th], [*jstate, jh], XLA_TOL, XLA_TOL)


def _slstm_params(seed=4, hh=2, dh=8):
    rng = np.random.default_rng(seed)
    r4 = (rng.normal(size=(hh, dh, 4 * dh)) * dh ** -0.5).astype(np.float32)
    b4 = rng.normal(size=(hh, 4 * dh)).astype(np.float32)
    return {"r4": r4, "b4": b4}


def test_slstm_step_vs_jax():
    rng = np.random.default_rng(5)
    b, hh, dh = 3, 2, 8
    p = _slstm_params(hh=hh, dh=dh)
    state = [rng.normal(size=(b, hh, dh)).astype(np.float32)
             for _ in range(4)]
    state[1] = np.abs(state[1])                    # n >= 0
    wx = (rng.normal(size=(b, hh, 4 * dh)) * 2).astype(np.float32)
    jstate, jh = jlayers._slstm_step(
        {k: jnp.asarray(a) for k, a in p.items()},
        tuple(map(jnp.asarray, state)), jnp.asarray(wx))
    tstate, th = layers._slstm_step(
        {k: torch.from_numpy(a) for k, a in p.items()},
        tuple(map(torch.from_numpy, state)), torch.from_numpy(wx))
    _close([*tstate, th], [*jstate, jh], XLA_TOL, XLA_TOL)


@pytest.mark.parametrize("t,chunk", [(12, 4), (10, 4), (7, 16)])
def test_chunked_scan_vs_jax(t, chunk):
    """The sLSTM's chunked scan, chunk shrunk to a divisor of T as JAX
    shrinks it (10 -> 2 x 5; 7 -> one chunk)."""
    b, hh, dh = 2, 2, 8
    p = _slstm_params(hh=hh, dh=dh)
    wx = (np.random.default_rng(t).normal(size=(t, b, hh, 4 * dh))
          ).astype(np.float32)
    init = [np.zeros((b, hh, dh), np.float32)] * 3 + [
        np.full((b, hh, dh), -1e30, np.float32)]
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    jstate, jys = jlayers._chunked_scan(
        lambda s, w: jlayers._slstm_step(jp, s, w[0]),
        tuple(map(jnp.asarray, init)), (jnp.asarray(wx),), chunk=chunk,
        remat=False)
    tp = {k: torch.from_numpy(a) for k, a in p.items()}
    tstate, tys = layers._chunked_scan(
        lambda s, w: layers._slstm_step(tp, s, w[0]),
        tuple(map(torch.from_numpy, init)), (torch.from_numpy(wx),),
        chunk=chunk, remat=False)
    assert tuple(tys.shape) == jys.shape
    _close([*tstate, tys], [*jstate, jys], XLA_TOL, XLA_TOL)


# ----------------------------------------------------------------------
# Recomputation leaves values and gradients bit-equal
# ----------------------------------------------------------------------

def _grads(fn, inputs):
    req = [x.detach().clone().requires_grad_(True) for x in inputs]
    out = fn(*req)
    loss = sum((o.float() ** 2).sum() for o in out)
    return loss.item(), torch.autograd.grad(loss, req)


def test_mlstm_chunk_remat_is_bit_equal():
    arrs = [torch.from_numpy(a) for a in _mlstm_inputs(2, 2, 40, 8, 6)]
    # (B, T, H, dh) / (B, T, H), as the layer calls it
    arrs = [a.transpose(1, 2).contiguous() for a in arrs]
    b, _, hh, dh = arrs[0].shape

    def run(remat):
        def fn(q, k, v, i, f):
            init = (torch.zeros(b, hh, dh, dh), torch.zeros(b, hh, dh),
                    torch.full((b, hh), -1e30))
            (C, n, m), h = ref.mlstm_chunkwise_torch(
                q, k, v, i, f, init, chunk=16, remat=remat)
            return C, n, h
        return _grads(fn, arrs)

    (l0, g0), (l1, g1) = run(False), run(True)
    assert l0 == l1
    for a, c in zip(g0, g1):
        torch.testing.assert_close(a, c, atol=0, rtol=0)


def test_slstm_chunked_scan_remat_is_bit_equal():
    p = {k: torch.from_numpy(a) for k, a in _slstm_params(hh=2, dh=8).items()}
    wx = torch.from_numpy(np.random.default_rng(7).normal(
        size=(12, 2, 2, 32)).astype(np.float32))
    init = tuple([torch.zeros(2, 2, 8)] * 3 + [torch.full((2, 2, 8), -1e30)])

    def run(remat):
        def fn(w, r4):
            pp = dict(p, r4=r4)
            state, ys = layers._chunked_scan(
                lambda s, x: layers._slstm_step(pp, s, x[0]), init, (w,),
                chunk=4, remat=remat)
            return (*state[:3], ys)
        return _grads(fn, [wx, p["r4"]])

    (l0, g0), (l1, g1) = run(False), run(True)
    assert l0 == l1
    for a, c in zip(g0, g1):
        torch.testing.assert_close(a, c, atol=0, rtol=0)


def test_xlstm_layer_remat_is_bit_equal():
    """Per-layer checkpointing (``cfg.remat``) over the mLSTM and sLSTM
    layers' own chunk checkpoints: loss and gradients equal."""
    jcfg = jax_config("xlstm-350m", reduced=True)
    jp = jinit(jcfg, jax.random.PRNGKey(1))
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    tcfg = get_config("xlstm-350m", reduced=True)
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.integers(0, tcfg.vocab, size=(1, 20)))
    y = torch.as_tensor(rng.integers(0, tcfg.vocab, size=(1, 20)))
    out = []
    for remat in (False, True):
        c = dataclasses.replace(tcfg, remat=remat)
        lv, td = flatten(tp)
        req = [l.detach().requires_grad_() for l in lv]
        loss = train_loss(c, unflatten(td, req), x, y)
        out.append((loss.item(), torch.autograd.grad(
            loss, req, allow_unused=True, materialize_grads=True)))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# ----------------------------------------------------------------------
# Reduced xlstm-350m: a prompt that pads the last mLSTM chunk
# ----------------------------------------------------------------------

def test_xlstm_padded_prefill_and_decode_vs_jax():
    """T = 150 runs the mLSTM prefill in two chunks of 128, the second
    padded with inert steps by the layer; then 3 greedy decode steps."""
    t, steps = 150, 3
    jcfg = jax_config("xlstm-350m", reduced=True)
    jp = jinit(jcfg, jax.random.PRNGKey(2))
    prompts = np.random.default_rng(9).integers(0, jcfg.vocab, size=(2, t))
    jlogits, jcaches = jprefill(jcfg, jp, jnp.asarray(prompts),
                                max_len=t + steps)
    tcfg = get_config("xlstm-350m", reduced=True).replace(
        attn_impl="pallas", rnn_impl="pallas")
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    def same(logits, caches, jlogits, jcaches):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=ATOL, rtol=RTOL)
        got = leaves(interop.to_numpy(caches))
        want = jax.tree_util.tree_leaves(jcaches)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, np.asarray(w), atol=ATOL,
                                       rtol=RTOL)

    before = dict(LAUNCHES)
    with torch.no_grad():
        logits, caches = prefill(tcfg, tp, torch.as_tensor(prompts),
                                 max_len=t + steps)
        same(logits, caches, jlogits, jcaches)
        jstep, tstep = jmake_serve(jcfg), make_serve_step(tcfg)
        jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
        tok = torch.argmax(logits, -1).to(torch.int32)
        for i in range(steps):
            jtok, jlogits, jcaches = jstep(jp, jcaches, jtok, t + i)
            tok, logits, caches = tstep(tp, caches, tok, t + i)
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
            same(logits, caches, jlogits, jcaches)
    assert dict(LAUNCHES) == before     # CPU tensors: the plain version


def test_xlstm_fl_train_step_vs_jax():
    """Two federated steps of reduced xlstm-350m over 2 pods against
    JAX's: the losses, and after the first step AdamW's first moment,
    which is (1 - b1) times the aggregated gradient (an mLSTM layer's
    unread up_r gets a zero gradient in both packages).  The parameters
    are not compared: AdamW divides each gradient element by its own
    magnitude, and the sLSTM input gate's bias has gradients that are
    zero up to rounding, which it turns into moves of up to lr.
    Tolerances: the FL step's 2e-5 for losses, the models' ``atol =
    1e-5, rtol = 1e-4`` for gradients."""
    lr, n_pods = 1e-3, 2
    jcfg = jax_config("xlstm-350m", reduced=True)
    tcfg = get_config("xlstm-350m", reduced=True)
    jp = jinit(jcfg, jax.random.PRNGKey(3))
    jo = jadamw_init(jp)
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    to = interop.opt_from_numpy(jax.tree_util.tree_map(np.asarray, jo),
                                "cpu")
    rng = np.random.default_rng(10)
    w = np.array([1.0, 3.0], np.float32)
    a = np.ones(n_pods, np.float32)
    jstep = jax.jit(jmake_step(jcfg, None, lr_schedule=jsched.constant_lr(lr),
                               n_pods=n_pods))
    tstep = make_fl_train_step(tcfg, lr_schedule=schedules.constant_lr(lr),
                               n_pods=n_pods)
    for i in range(2):
        batch = {k: rng.integers(0, tcfg.vocab, size=(n_pods, 2, 12))
                 for k in ("inputs", "labels")}
        jp, jo, jm = jstep(jp, jo, jax.tree_util.tree_map(jnp.asarray,
                                                          batch),
                           jnp.asarray(w), jnp.asarray(a))
        tp, to, tm = tstep(tp, to, tree_map(torch.as_tensor, batch),
                           torch.from_numpy(w), torch.from_numpy(a))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=2e-5, rtol=2e-5)
        if i == 0:
            got = leaves(interop.to_numpy(to.m))
            want = jax.tree_util.tree_leaves(jo.m)
            assert len(got) == len(want)
            for g, w_ in zip(got, want):
                np.testing.assert_allclose(g / 0.1, np.asarray(w_) / 0.1,
                                           atol=ATOL, rtol=RTOL)


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,dh,chunk,dtype,gsc,layout", [
    # the FMA route
    (2, 4, 64, 16, 16, "float32", 1.0, "bhtd"),
    (2, 3, 160, 80, 32, "float32", 1.0, "bhtd"),
    (1, 2, 64, 32, 32, "bfloat16", 1.0, "bhtd"),
    # the tensor-core route: dh 512, 256, 96, 64 and 32, chunk 64 and
    # 128, gates x10, the layer's (B, T, H, dh) views, bf16, one chunk,
    # T = 2048
    (1, 2, 256, 512, 128, "float32", 1.0, "bhtd"),
    (1, 4, 256, 512, 128, "float32", 10.0, "bthd"),
    (2, 4, 2048, 512, 128, "float32", 1.0, "bthd"),
    (2, 2, 256, 256, 64, "float32", 10.0, "bthd"),
    (1, 2, 512, 96, 128, "float32", 1.0, "bhtd"),
    (1, 3, 128, 64, 128, "float32", 10.0, "bhtd"),
    (2, 2, 2048, 32, 128, "float32", 1.0, "bthd"),
    (2, 4, 256, 512, 128, "bfloat16", 1.0, "bthd"),
    (2, 2, 64, 32, 64, "bfloat16", 10.0, "bhtd")])
def test_cuda_mlstm_matches_plain_version(b, h, t, dh, chunk, dtype, gsc,
                                          layout):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dt = getattr(torch, dtype)
    arrs = _mlstm_inputs(b, h, t, dh, 1, gsc)
    if layout == "bthd":   # transposed views of (B, T, H, ...) tensors
        arrs = [np.ascontiguousarray(np.swapaxes(a, 1, 2)) for a in arrs]
    q, k, v, ip, fp = (torch.from_numpy(a).cuda() for a in arrs)
    if layout == "bthd":
        q, k, v, ip, fp = (x.transpose(1, 2) for x in (q, k, v, ip, fp))
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    want_route = "tc" if chunk in (64, 128) and dh % 32 == 0 else "fma"
    assert kmlstm.route(dt, dh, chunk) == want_route
    before = LAUNCHES["mlstm_chunkwise"]
    got = ops.mlstm(q, k, v, ip, fp, chunk=chunk, impl="cuda")
    assert LAUNCHES["mlstm_chunkwise"] == before + 1
    want = ops.mlstm(q.float(), k.float(), v.float(), ip, fp, chunk=chunk,
                     impl="torch")
    tol = KERNEL_TOL if dt == torch.float32 else BF16_TOL
    assert got[0].dtype == dt
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w, atol=tol, rtol=tol)
