"""The plain attention path against JAX's ``"xla"`` path, on the CPU.

``ops.attention(impl="torch")`` is what the models train and the dry run
traces.  Like JAX's ``impl="xla"`` it takes the two-block sliding-window
route (``ref.attention_swa``, the port of ``_xla_attention_swa``) for a
causal window over a full sequence longer than two windows, and the
q-chunked route (``ref.attention_qchunk``) otherwise, whose q blocks are
recomputed in backward as ``jax.checkpoint(..., nothing_saveable)``
recomputes JAX's.  Held here: values and gradients of both routes
against JAX's at f32 ``atol = rtol = 3e-5`` (padded tails, T = 2W + 1,
GQA, MQA, softcap on and off); the route taken, case by case, against
the route JAX takes; the FLOPs ``CostCounter`` counts, forward and
forward plus backward, within 2% of ``hlo_analysis.analyze`` on the
jitted JAX function; what backward keeps of the q-chunked route (the
inputs, not every block's scores); and its no-grad output bit-equal to
the loop it had before the recompute.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.launch import hlo_analysis as H  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import cost_analysis as C  # noqa: E402

ATTN_TOL = 3e-5
FLOPS_REL = 0.02

# b, hq, hkv, T, window, d, softcap
SWA_CASES = [
    (2, 4, 2, 48, 16, 32, None),       # T a multiple of W, GQA group 2
    (1, 4, 2, 45, 16, 32, 30.0),       # a padded tail, softcap
    (1, 4, 4, 33, 16, 16, None),       # T = 2W + 1, MHA
    (2, 4, 1, 50, 8, 32, 50.0),        # MQA, a padded tail
    (1, 6, 2, 67, 16, 64, None),       # T = 4W + 3, group 3
]


def _inputs(b, hq, hkv, tq, tk, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, tq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, tk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, tk, d)).astype(np.float32)
    g = rng.standard_normal((b, hq, tq, d)).astype(np.float32)
    return q, k, v, g


def _torch_vjp(fn, q, k, v, g):
    req = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = fn(*req)
    grads = torch.autograd.grad(out, req, torch.tensor(g))
    return [out.detach().numpy()] + [x.numpy() for x in grads]


def _jax_vjp(fn, q, k, v, g):
    def f(q, k, v, g):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out, *vjp(g))
    return [np.asarray(x) for x in jax.jit(f)(q, k, v, g)]


@pytest.mark.parametrize("case", SWA_CASES)
def test_attention_swa_matches_jax(case):
    b, hq, hkv, t, w, d, cap = case
    q, k, v, g = _inputs(b, hq, hkv, t, t, d)
    got = _torch_vjp(lambda *a: ref.attention_swa(
        *a, softcap=cap, scale=None, window=w), q, k, v, g)
    want = _jax_vjp(lambda *a: jops._xla_attention_swa(
        *a, softcap=cap, q_offset=0, scale=None, window=w), q, k, v, g)
    for name, x, y in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x, y, atol=ATTN_TOL, rtol=ATTN_TOL,
                                   err_msg=name)


# b, hq, hkv, tq, tk, d, causal, window, softcap, q_offset, block_q
QCHUNK_CASES = [
    (1, 4, 2, 67, 67, 32, True, None, None, 0, 16),
    (2, 4, 1, 40, 40, 16, True, 8, 30.0, 0, 16),
    (1, 4, 4, 20, 50, 32, False, None, None, 0, 8),
    (1, 4, 2, 24, 60, 32, True, 16, None, 36, 8),
]


@pytest.mark.parametrize("case", QCHUNK_CASES)
def test_attention_qchunk_recompute_matches_jax(case):
    b, hq, hkv, tq, tk, d, causal, w, cap, qo, bq = case
    q, k, v, g = _inputs(b, hq, hkv, tq, tk, d, seed=1)
    kw = dict(causal=causal, window=w, softcap=cap, q_offset=qo,
              kv_offset=0, scale=None, block_q=bq)
    got = _torch_vjp(lambda *a: ref.attention_qchunk(*a, **kw), q, k, v, g)
    want = _jax_vjp(lambda *a: jops._xla_attention_qchunk(*a, **kw),
                    q, k, v, g)
    for name, x, y in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x, y, atol=ATTN_TOL, rtol=ATTN_TOL,
                                   err_msg=name)


# tq, tk, causal, window, q_offset, kv_offset -> two-block route?
ROUTE_CASES = [
    ((33, 33, True, 16, 0, 0), True),      # T = 2W + 1
    ((67, 67, True, 16, 0, 0), True),
    ((32, 32, True, 16, 0, 0), False),     # T = 2W
    ((20, 20, True, 16, 0, 0), False),
    ((67, 67, True, 16, 3, 3), False),     # offsets not 0
    ((67, 67, True, 16, 0, 2), False),
    ((67, 67, False, 16, 0, 0), False),    # not causal
    ((67, 67, True, None, 0, 0), False),   # no window
    ((40, 67, True, 16, 0, 0), False),     # Tq != Tk
]


@pytest.mark.parametrize("case,want", ROUTE_CASES)
def test_dispatch_takes_the_two_block_route_where_jax_does(case, want,
                                                           monkeypatch):
    tq, tk, causal, w, qo, ko = case
    taken = {"torch": [], "jax": []}
    real_t, real_j = ref.attention_swa, jops._xla_attention_swa
    monkeypatch.setattr(ref, "attention_swa", lambda *a, **k: (
        taken["torch"].append(True), real_t(*a, **k))[1])
    monkeypatch.setattr(jops, "_xla_attention_swa", lambda *a, **k: (
        taken["jax"].append(True), real_j(*a, **k))[1])
    q, k, v, _ = _inputs(1, 4, 2, tq, tk, 16, seed=2)
    kw = dict(causal=causal, window=w, softcap=None, q_offset=qo,
              kv_offset=ko, block_q=16)
    got = ops.attention(*(torch.tensor(x) for x in (q, k, v)),
                        impl="torch", **kw)
    out = jops.attention(q, k, v, impl="xla", **kw)
    assert bool(taken["torch"]) == bool(taken["jax"]) == want
    assert ops.swa_route(tq, tk, causal=causal, window=w, q_offset=qo,
                         kv_offset=ko) == want
    np.testing.assert_allclose(got.numpy(), np.asarray(out),
                               atol=ATTN_TOL, rtol=ATTN_TOL)


def test_a_tensor_offset_never_takes_the_two_block_route():
    assert not ops.swa_route(67, 67, causal=True, window=16,
                             q_offset=torch.tensor(0), kv_offset=0)


@pytest.mark.parametrize("window", [16, None], ids=["local", "global"])
def test_flops_match_jax_hlo_analysis(window):
    """A local layer at T = 4W + 3 (the two-block route) and a global
    one (five recomputed q blocks): the counted FLOPs of the forward
    and of the forward plus backward within 2% of JAX's jitted
    ``impl="xla"``.  The forward's output stays live in the JAX program
    (``value_and_grad``), as it does in the torch one."""
    b, hq, hkv, w, d = 1, 4, 2, 16, 64
    t = 4 * w + 3
    q, k, v, g = _inputs(b, hq, hkv, t, t, d, seed=3)
    kw = dict(causal=True, window=window, softcap=None, block_q=16)

    def jf(q, k, v):
        return jops.attention(q, k, v, impl="xla", **kw)

    jg = jax.value_and_grad(lambda q, k, v: (jf(q, k, v) * g).sum(),
                            argnums=(0, 1, 2))
    j_fwd = H.analyze(jax.jit(jf).lower(q, k, v).compile().as_text())
    j_all = H.analyze(jax.jit(jg).lower(q, k, v).compile().as_text())

    tq, tk, tv, tg = (torch.tensor(x) for x in (q, k, v, g))
    with C.CostCounter(fake=False) as fwd:
        ops.attention(tq, tk, tv, impl="torch", **kw)
    req = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    with C.CostCounter(fake=False) as both:
        out = ops.attention(*req, impl="torch", **kw)
        torch.autograd.grad((out * tg).sum(), req)
    assert fwd.costs.flops == pytest.approx(j_fwd.flops, rel=FLOPS_REL)
    assert both.costs.flops == pytest.approx(j_all.flops, rel=FLOPS_REL)


def _saved_bytes(fn, *args) -> int:
    """Bytes of the distinct storages autograd saves for backward."""
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(*args)
    return sum(seen.values())


def _qchunk_before(q, k, v, *, causal, window, softcap, q_offset,
                   kv_offset, scale, block_q):
    """``attention_qchunk`` as it was before the per-block recompute."""
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    group = hq // hkv
    sc = (d ** -0.5) if scale is None else scale
    block_q = max(1, min(block_q, tq))
    pad_q = (-tq) % block_q
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, pad_q))
    nq = q.shape[2] // block_q
    kf, vf = k.float(), v.float()
    k_pos = kv_offset + torch.arange(tk)[None, :]
    outs = []
    for qi in range(nq):
        qf = q[:, :, qi * block_q:(qi + 1) * block_q].float()
        qg = qf.reshape(b, hkv, group, block_q, d)
        s = torch.einsum("bkgqd,bktd->bkgqt", qg, kf) * sc
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        q_pos = (q_offset + qi * block_q + torch.arange(block_q))[:, None]
        mask = (k_pos >= 0).expand(block_q, tk)
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window is not None:
            mask = mask & (k_pos > q_pos - window)
        s = torch.where(mask, s, ref.NEG_INF)
        p = torch.softmax(s, dim=-1)
        p = torch.where(mask.any(-1)[:, None], p, 0.0)
        o = torch.einsum("bkgqt,bktd->bkgqd", p, vf)
        outs.append(o.reshape(b, hq, block_q, d))
    out = outs[0] if nq == 1 else torch.cat(outs, dim=2)
    return out[:, :, :tq].to(q.dtype)


def test_qchunk_backward_keeps_one_block_of_scores():
    """Four q blocks: what backward holds is at most the inputs plus one
    block's f32 scores.  The loop without the recompute held every
    block's scores and probabilities, which the same measure sees."""
    b, hq, hkv, t, d, bq = 1, 4, 2, 64, 16, 16
    q, k, v, _ = _inputs(b, hq, hkv, t, t, d, seed=4)
    req = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    kw = dict(causal=True, window=None, softcap=None, q_offset=0,
              kv_offset=0, scale=None, block_q=bq)
    limit = sum(x.numel() * 4 for x in req) + b * hq * bq * t * 4
    assert _saved_bytes(lambda *a: ref.attention_qchunk(*a, **kw),
                        *req) <= limit
    assert _saved_bytes(lambda *a: _qchunk_before(*a, **kw),
                        *req) > limit


@pytest.mark.parametrize("case", QCHUNK_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_qchunk_without_grad_is_bit_equal_to_before(case, dtype):
    b, hq, hkv, tq, tk, d, causal, w, cap, qo, bq = case
    q, k, v, _ = _inputs(b, hq, hkv, tq, tk, d, seed=5)
    q, k, v = (torch.tensor(x).to(dtype) for x in (q, k, v))
    kw = dict(causal=causal, window=w, softcap=cap, q_offset=qo,
              kv_offset=0, scale=None, block_q=bq)
    with torch.no_grad():
        got = ref.attention_qchunk(q, k, v, **kw)
    assert torch.equal(got, _qchunk_before(q, k, v, **kw))
    # with grad enabled but no input requiring it: the same loop too
    assert torch.equal(ref.attention_qchunk(q, k, v, **kw), got)
    # the recomputed forward gives the same bits
    req = [x.clone().requires_grad_(True) for x in (q, k, v)]
    assert torch.equal(ref.attention_qchunk(*req, **kw).detach(), got)
