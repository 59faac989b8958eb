"""The port's serving path against the JAX package's, on the CPU.

Reduced gemma2-2b, gemma3-4b, recurrentgemma-2b (float32, window 16),
xlstm-350m and the moe archs olmoe-1b-7b and granite-moe-1b-a400m, with
prompts shorter and longer than the window, so the
local caches are left-padded in one case and cut to the last ``window``
keys in the other, and roll during decode.  Both packages start from the
same JAX-initialised weights (``repro_torch.interop``).  JAX runs its
Pallas attention kernel in interpret mode, its XLA rglru scan and its
chunkwise mLSTM; the port runs ``attn_impl="pallas"``/
``rnn_impl="pallas"``, which on CPU tensors is the plain version inside
each kernel wrapper.  JAX's
interpret decode runs only unjitted, with a Python-int ``pos``.
Tolerance: ``atol=1e-5, rtol=1e-4`` for logits and caches, as for the
model tests; greedy tokens equal.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.dist.fl_step import make_serve_step as jmake_serve  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models.model import init_decode_cache as jinit_cache  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist.fl_step import make_serve_step  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import init_decode_cache, prefill  # noqa: E402
from repro_torch.tree import flatten, leaves  # noqa: E402

ATOL, RTOL = 1e-5, 1e-4
ARCHS = ["gemma2-2b", "gemma3-4b", "recurrentgemma-2b", "xlstm-350m",
         "olmoe-1b-7b", "granite-moe-1b-a400m"]
PROMPTS = [10, 37]          # shorter and longer than the window (16)
STEPS = 4
BATCH = 2


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def _close_trees(got, want):
    gl = leaves(interop.to_numpy(got))
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)


def _port_config(arch):
    return get_config(arch, reduced=True).replace(attn_impl="pallas",
                                                  rnn_impl="pallas")


@functools.lru_cache(maxsize=None)
def _jax_run(arch, t):
    """JAX prefill + STEPS greedy decode steps; everything as numpy."""
    cfg = jax_config(arch, reduced=True).replace(attn_impl="interpret",
                                                 rnn_impl="xla")
    params = jinit(cfg, jax.random.PRNGKey(0))
    prompts = np.random.default_rng(t).integers(0, cfg.vocab,
                                                size=(BATCH, t))
    logits, caches = jprefill(cfg, params, jnp.asarray(prompts),
                              max_len=t + STEPS + 1)
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    run = {"params": to_np(params), "prompts": prompts,
           "prefill": (np.asarray(logits), to_np(caches)), "steps": []}
    step = jmake_serve(cfg)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for i in range(STEPS):
        nxt, logits, caches = step(params, caches, tok, t + i)
        run["steps"].append((np.asarray(tok), np.asarray(nxt),
                             np.asarray(logits), to_np(caches)))
        tok = nxt
    return run


@pytest.mark.parametrize("t", PROMPTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_vs_jax(arch, t):
    run = _jax_run(arch, t)
    cfg = _port_config(arch)
    params = interop.params_from_numpy(run["params"], "cpu")
    with torch.no_grad():
        logits, caches = prefill(cfg, params,
                                 torch.as_tensor(run["prompts"]),
                                 max_len=t + STEPS + 1)
        assert logits.dtype == torch.float32
        assert logits.shape == (BATCH, cfg.vocab)
        _close(logits.numpy(), run["prefill"][0])
        _close_trees(caches, run["prefill"][1])
        step = make_serve_step(cfg)
        tok = torch.argmax(logits, -1).to(torch.int32)
        for i, (jtok, jnxt, jlogits, jcaches) in enumerate(run["steps"]):
            np.testing.assert_array_equal(tok.numpy(), jtok)
            tok, logits, caches = step(params, caches, tok, t + i)
            assert tok.dtype == torch.int32
            np.testing.assert_array_equal(tok.numpy(), jnxt)
            _close(logits.numpy(), jlogits)
            _close_trees(caches, jcaches)


@pytest.mark.parametrize("arch", ["gemma2-2b", "recurrentgemma-2b",
                                  "xlstm-350m"])
def test_jax_prefill_cache_continues_in_the_port(arch):
    """A JAX prefill cache, carried with ``interop``, decodes on in the
    port exactly as it does in JAX."""
    t = PROMPTS[1]
    run = _jax_run(arch, t)
    cfg = _port_config(arch)
    params = interop.params_from_numpy(run["params"], "cpu")
    caches = interop.params_from_numpy(run["prefill"][1], "cpu")
    step = make_serve_step(cfg)
    with torch.no_grad():
        for i, (jtok, jnxt, jlogits, jcaches) in enumerate(run["steps"]):
            tok, logits, caches = step(params, caches, torch.tensor(jtok),
                                       t + i)
            np.testing.assert_array_equal(tok.numpy(), jnxt)
            _close(logits.numpy(), jlogits)
            _close_trees(caches, jcaches)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_tree_matches_jax(arch):
    jcfg = jax_config(arch, reduced=True)
    want = jinit_cache(jcfg, 3, 40)
    got = init_decode_cache(get_config(arch, reduced=True), 3, 40)
    wl, wdef = jax.tree_util.tree_flatten(want)
    gl, gdef = flatten(got)
    assert wdef.num_leaves == gdef.num_leaves
    for w, g in zip(wl, gl):
        assert tuple(w.shape) == tuple(g.shape)
        assert str(w.dtype) == str(g.dtype).replace("torch.", "")
        np.testing.assert_array_equal(interop.to_numpy(g), np.asarray(w))


@pytest.mark.parametrize("arch", ["gemma2-2b", "recurrentgemma-2b",
                                  "xlstm-350m", "olmoe-1b-7b",
                                  "granite-moe-1b-a400m"])
def test_serve_driver_on_the_cpu(arch):
    stats = {}
    toks = serve.main(["--arch", arch, "--batch", "3", "--prompt-len", "20",
                       "--gen", "5", "--device", "cpu"], stats=stats)
    vocab = get_config(arch, reduced=True).vocab
    assert toks.shape == (3, 5) and toks.dtype == np.int32
    assert ((toks >= 0) & (toks < vocab)).all()
    assert stats["logits"].shape == (3, vocab)
    assert np.isfinite(stats["logits"].numpy()).all()
    # greedy: the first token is the prefill's argmax
    np.testing.assert_array_equal(toks[:, 0],
                                  stats["logits"].argmax(-1).numpy())
