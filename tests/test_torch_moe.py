"""The port's ``moe`` layer kind against the JAX package's, on the CPU.

``_moe_ffn_block`` and ``_moe_ffn`` of ``repro_torch.models.layers``
against ``repro.models.layers``, fed the same numpy inputs and the same
JAX-initialised layer parameters (``repro_torch.interop``), at the
reduced moe configs (8 experts, top 2): with dropped assignments, with
token blocking (192 tokens in 3 blocks of 64, each with its own
capacity), with exact ties in the router's probabilities, in bf16, and
the gradients of ``_moe_ffn`` (router included) against ``jax.grad``.
Tolerances: ``atol=1e-5, rtol=1e-4`` in f32, ``1e-2`` in bf16.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import init_params, layers  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ATOL, RTOL = 1e-5, 1e-4
BF16_TOL = 1e-2
MOE_ARCHS = ["olmoe-1b-7b", "granite-moe-1b-a400m"]


def _setup(arch, *, dtype="float32", seed=0, **over):
    """Both packages' reduced configs (with ``over``) and one moe
    layer's JAX-initialised parameters, carried into the port."""
    jcfg = jax_config(arch, reduced=True).replace(dtype=dtype, **over)
    tcfg = get_config(arch, reduced=True).replace(dtype=dtype, **over)
    jp = jlayers.init_layer(jcfg, "moe", jax.random.PRNGKey(seed))
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    return jcfg, tcfg, jp, tp


def _tokens(cfg, n, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, cfg.d_model)).astype(np.float32)


def _cap(cfg, n):
    cap = math.ceil(n * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-cap // 8) * 8)


def _n_dropped(cfg, router, x, block):
    """Assignments past their expert's capacity, counted block by block
    from the port's routing (top-k of the f32 router's softmax)."""
    dropped = 0
    for xb in np.split(x, len(x) // block):
        probs = torch.softmax(torch.from_numpy(xb) @ router, -1)
        idx = layers._top_k(probs, cfg.top_k)[1].numpy()
        counts = np.bincount(idx.ravel(), minlength=cfg.n_experts)
        dropped += int(np.maximum(counts - _cap(cfg, block), 0).sum())
    return dropped


def _close(got, want, tol=None):
    atol, rtol = (ATOL, RTOL) if tol is None else (tol, tol)
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_with_drops_vs_jax(arch):
    jcfg, tcfg, jp, tp = _setup(arch, capacity_factor=0.5)
    x = _tokens(tcfg, 48)
    assert _n_dropped(tcfg, tp["router"], x, 48) > 0
    want = jlayers._moe_ffn_block(jcfg, jp, jnp.asarray(x))
    got = layers._moe_ffn_block(tcfg, tp, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got.numpy(), want)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_token_blocks_vs_jax(arch):
    """192 tokens route in 3 blocks of 64, each with its own capacity;
    a single routing of all 192 drops other assignments."""
    jcfg, tcfg, jp, tp = _setup(arch, capacity_factor=0.5)
    x = _tokens(tcfg, 192, seed=1)
    assert _n_dropped(tcfg, tp["router"], x, 64) > 0
    h = x.reshape(3, 64, -1)
    want = jlayers._moe_ffn(jcfg, jp, jnp.asarray(h))
    got = layers._moe_ffn(tcfg, tp, torch.from_numpy(h))
    _close(got.numpy(), want)
    whole = layers._moe_ffn_block(tcfg, tp, torch.from_numpy(x))
    assert not np.allclose(whole.numpy(), got.reshape(192, -1).numpy(),
                           atol=ATOL, rtol=RTOL)
    with torch.no_grad():
        _close(layers._moe_ffn(tcfg, tp, torch.from_numpy(h)).numpy(), want)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_router_ties_follow_lax_top_k(arch):
    """Experts whose router columns are zero (exactly equal logits) or
    duplicated tie exactly; the port picks among equal probabilities the
    lower expert index, as ``jax.lax.top_k`` does."""
    jcfg, tcfg, jp, tp = _setup(arch)
    router = np.asarray(jp["router"]).copy()
    router[:, 1] = router[:, 0]
    router[:, 4:] = 0.0
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = _tokens(tcfg, 64, seed=2)
    probs = torch.softmax(torch.from_numpy(x) @ tp["router"], -1)
    k = tcfg.top_k
    vals, idx = layers._top_k(probs, k)
    srt = torch.sort(probs, -1, descending=True).values
    # ties at the selection boundary: the k-th and the next are equal
    assert int((srt[:, k - 1] == srt[:, k]).sum()) > 0
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    want = jlayers._moe_ffn_block(jcfg, jp, jnp.asarray(x))
    got = layers._moe_ffn_block(tcfg, tp, torch.from_numpy(x))
    _close(got.numpy(), want)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_bf16_vs_jax(arch):
    jcfg, tcfg, jp, tp = _setup(arch, dtype="bfloat16", capacity_factor=1.0)
    assert tp["router"].dtype == torch.float32
    assert tp["moe_gate"].dtype == torch.bfloat16
    x = _tokens(tcfg, 128, seed=3)
    h = x.reshape(2, 64, -1)
    want = jlayers._moe_ffn(jcfg, jp, jnp.asarray(h, jnp.bfloat16))
    got = layers._moe_ffn(tcfg, tp, torch.from_numpy(h).bfloat16())
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want, np.float32), BF16_TOL)


@pytest.mark.parametrize("cf,bt", [(0.5, (3, 64)), (8.0, (2, 24))])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_grads_vs_jax(arch, cf, bt):
    """Gradients of sum(w * _moe_ffn(h)) for the input and each
    parameter, the f32 router included: through 3 token blocks with
    drops (each block checkpointed), and through one block without."""
    jcfg, tcfg, jp, tp = _setup(arch, capacity_factor=cf)
    h = _tokens(tcfg, bt[0] * bt[1], seed=4).reshape(bt + (-1,))
    w = np.random.default_rng(5).normal(size=h.shape).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jlayers._moe_ffn(jcfg, p, x) * w)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(h))

    names = ["router", "moe_gate", "moe_up", "moe_down"]
    req = {name: tp[name].detach().requires_grad_() for name in names}
    x = torch.from_numpy(h).requires_grad_()
    out = layers._moe_ffn(tcfg, req, x)
    tg = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                             [req[name] for name in names] + [x])
    _close(tg[-1].numpy(), jgx)
    for name, g in zip(names, tg):
        assert tuple(g.shape) == tuple(jgp[name].shape), name
        _close(g.numpy(), jgp[name])
    assert float(tg[0].abs().sum()) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_layer_dispatch_and_cache(arch):
    """init_layer, apply_layer and init_cache accept "moe": a moe layer
    has the four expert parameters and no dense FFN, and its cache is a
    global layer's, max_len entries."""
    cfg = get_config(arch, reduced=True)
    gen = torch.Generator().manual_seed(0)
    p = layers.init_layer(cfg, "moe", gen)
    assert {"router", "moe_gate", "moe_up", "moe_down"} <= set(p)
    assert not {"w_gate", "w_up", "w_down"} & set(p)
    e, d, fe = cfg.n_experts, cfg.d_model, cfg.d_expert
    assert tuple(p["moe_gate"].shape) == (e, d, fe)
    assert tuple(p["moe_down"].shape) == (e, fe, d)
    cache = layers.init_cache(cfg, "moe", 2, 40)
    want = layers.init_cache(cfg, "global", 2, 40)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    x = torch.randn((2, 9, d), generator=gen)
    with torch.no_grad():
        y, c = layers.apply_layer(cfg, "moe", p, x, "prefill", cache)
        assert c is cache and y.shape == x.shape
        y1, _ = layers.apply_layer(cfg, "moe", p, x[:, :1], "decode", cache,
                                   9)
    assert torch.isfinite(y).all() and torch.isfinite(y1).all()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_stays_f32_in_a_bf16_model(arch):
    cfg = get_config(arch, reduced=True).replace(dtype="bfloat16")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    for name, w in params["cycles"]["slot0"].items():
        want = torch.float32 if name == "router" else torch.bfloat16
        assert w.dtype == want, name
    assert all(l.dtype in (torch.float32, torch.bfloat16)
               for l in leaves(params))
