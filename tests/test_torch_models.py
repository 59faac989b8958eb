"""The port's model stack against the JAX package's, on the CPU.

Both packages start from the same JAX-initialised weights, carried over
with ``repro_torch.interop``, and see the same numpy inputs.  Reduced
configs in float32; tolerance ``atol=1e-5, rtol=1e-4`` for activations,
losses and gradients (f32 sums taken in another order).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import train_loss as jtrain_loss  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.models import common, forward, init_params  # noqa: E402
from repro_torch.models import param_count, train_loss  # noqa: E402
from repro_torch.tree import flatten, unflatten  # noqa: E402

ATOL, RTOL = 1e-5, 1e-4
# every configuration whose layers are all "global"
GLOBAL_ARCHS = ["qwen3-1.7b", "deepseek-7b", "chameleon-34b",
                "hubert-xlarge"]
# the configurations the serving slice ports: "local" and "rglru" layers
SERVE_ARCHS = ["gemma2-2b", "gemma3-4b", "recurrentgemma-2b"]
# "mlstm" and "slstm" layers
XLSTM_ARCHS = ["xlstm-350m"]
# "moe" layers
MOE_ARCHS = ["granite-moe-1b-a400m", "olmoe-1b-7b"]


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


def _carry(arch, seed=0):
    cfg = jax_config(arch, reduced=True)
    jp = jinit(cfg, jax.random.PRNGKey(seed))
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    return cfg, get_config(arch, reduced=True), jp, tp


def _inputs(cfg, b=2, t=24, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.has_embedding:
        x = rng.integers(0, cfg.vocab, size=(b, t))
    else:
        x = rng.normal(size=(b, t, cfg.d_model)).astype(np.float32)
    y = rng.integers(0, cfg.vocab, size=(b, t))
    return x, y


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_field_by_field(arch):
    for reduced in (False, True):
        assert (dataclasses.asdict(get_config(arch, reduced=reduced))
                == dataclasses.asdict(jax_config(arch, reduced=reduced)))
        assert (get_config(arch, reduced=reduced).param_count()
                == jax_config(arch, reduced=reduced).param_count())


def test_rms_norm_vs_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32) * 3
    s = rng.normal(size=(32,)).astype(np.float32)
    _close(common.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6))


@pytest.mark.parametrize("pos_rank", [1, 2])
def test_rope_vs_jax(pos_rank):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4, 9, 16)).astype(np.float32)
    pos = (np.arange(9) + 5 if pos_rank == 1
           else rng.integers(0, 500, size=(2, 9)))
    _close(common.rope(torch.from_numpy(x), torch.as_tensor(pos), 1e6),
           jcommon.rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


@pytest.mark.parametrize("softcap,chunk", [(None, 8), (None, 7),
                                           (30.0, 16)])
def test_chunked_ce_loss_vs_jax(softcap, chunk):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 20, 16)).astype(np.float32)
    e = rng.normal(size=(16, 50)).astype(np.float32)
    y = rng.integers(0, 50, size=(2, 20))
    m = (rng.uniform(size=(2, 20)) > 0.2).astype(np.float32)
    got = common.chunked_ce_loss(torch.from_numpy(x), torch.from_numpy(e),
                                 torch.as_tensor(y), torch.from_numpy(m),
                                 softcap=softcap, chunk=chunk)
    want = jcommon.chunked_ce_loss(jnp.asarray(x), jnp.asarray(e),
                                   jnp.asarray(y), jnp.asarray(m),
                                   softcap=softcap, chunk=chunk)
    _close(got.item(), float(want))


def test_embed_and_unembed_keep_jax_numerics_in_bf16():
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(30, 64)).astype(np.float32)
    tok = rng.integers(0, 30, size=(2, 5))
    tb = torch.from_numpy(emb).bfloat16()
    jb = jnp.asarray(emb, jnp.bfloat16)
    x = common.embed_tokens(tb, torch.as_tensor(tok), 64)
    jx = jcommon.embed_tokens(jb, jnp.asarray(tok), 64)
    assert x.dtype == torch.bfloat16
    np.testing.assert_array_equal(x.float().numpy(),
                                  np.asarray(jx.astype(jnp.float32)))
    logits = common.unembed_logits(x, tb.T, None)
    assert logits.dtype == torch.float32
    _close(logits.numpy(), jcommon.unembed_logits(jx, jb.T, None),
           atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("arch", GLOBAL_ARCHS + SERVE_ARCHS + XLSTM_ARCHS
                         + MOE_ARCHS)
def test_init_params_tree_matches_jax(arch):
    cfg, tcfg, jp, _ = _carry(arch)
    gen = torch.Generator().manual_seed(0)
    tp = init_params(tcfg, gen)
    jl, jdef = jax.tree_util.tree_flatten(jp)
    tl, tdef = flatten(tp)
    assert len(jl) == len(tl) and jdef.num_leaves == tdef.num_leaves
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
    assert param_count(tp) == sum(a.size for a in jl)
    if not {"rglru", "mlstm", "slstm"} & set(tcfg.pattern):
        # ArchConfig's analytic count (shared with repro) only
        # approximates the recurrent layers (an rglru layer's gates,
        # xLSTM's projections); both packages' trees agree with each other
        assert param_count(tp) == tcfg.param_count()
    if "moe" in tcfg.pattern:
        # the router is f32 in any model dtype, as in repro
        assert tp["cycles"]["slot0"]["router"].dtype == torch.float32


@pytest.mark.parametrize("arch", GLOBAL_ARCHS + SERVE_ARCHS + XLSTM_ARCHS
                         + MOE_ARCHS)
def test_forward_vs_jax(arch):
    cfg, tcfg, jp, tp = _carry(arch)
    x, _ = _inputs(cfg)
    want = jforward(cfg, jp, jnp.asarray(x))
    got = forward(tcfg, tp, torch.as_tensor(x))
    assert got.dtype == torch.float32
    _close(got.detach().numpy(), want)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "hubert-xlarge"]
                         + SERVE_ARCHS + XLSTM_ARCHS + MOE_ARCHS)
def test_train_loss_and_grads_vs_jax(arch):
    cfg, tcfg, jp, tp = _carry(arch)
    x, y = _inputs(cfg, seed=1)
    jl, jg = jax.value_and_grad(
        lambda p: jtrain_loss(cfg, p, jnp.asarray(x), jnp.asarray(y),
                              ce_chunk=8))(jp)
    leaves, td = flatten(tp)
    req = [l.detach().requires_grad_() for l in leaves]
    tl = train_loss(tcfg, unflatten(td, req), torch.as_tensor(x),
                    torch.as_tensor(y), ce_chunk=8)
    # an mLSTM layer never reads its up_r (nor does JAX's): zero grads
    tg = torch.autograd.grad(tl, req, allow_unused=True,
                             materialize_grads=True)
    _close(tl.item(), float(jl))
    for a, b in zip(jax.tree_util.tree_leaves(jg), tg):
        assert tuple(a.shape) == tuple(b.shape)
        _close(b.numpy(), a)


@pytest.mark.parametrize("arch,t", [("qwen3-1.7b", 24),
                                    ("olmoe-1b-7b", 96)])
def test_remat_changes_no_value(arch, t):
    """Per-layer checkpointing recomputes; loss and grads are equal.
    olmoe's 2 x 96 tokens route in 3 checkpointed blocks of 64, inside
    the checkpointed layer."""
    _, tcfg, _, tp = _carry(arch)
    x, y = _inputs(tcfg, t=t, seed=2)
    out = []
    for remat in (False, True):
        c = dataclasses.replace(tcfg, remat=remat)
        leaves, td = flatten(tp)
        req = [l.detach().requires_grad_() for l in leaves]
        loss = train_loss(c, unflatten(td, req), torch.as_tensor(x),
                          torch.as_tensor(y))
        out.append((loss.item(), torch.autograd.grad(loss, req)))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
