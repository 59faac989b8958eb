"""Unified LM: init / forward / train loss / prefill / decode.

Port of ``repro/models/model.py`` with the same parameter tree, so
parameters carry across the two packages one to one:

    embed / adapter_in+head (hubert)   — input/output embeddings
    cycles = {"slot<i>": stacked params (leading dim n_cycles)}
    tail   = [per-layer params]        — n_layers % len(pattern) layers
    final_norm

The JAX code runs ``lax.scan`` over the stacked cycles; here a Python
loop walks the layers.  Each stacked tensor is unbound once per call,
so autograd gathers its gradient with one ``stack`` rather than one
full-size scatter per layer.  ``cfg.remat`` checkpoints each layer
(``layers.checkpointed``: ``torch.utils.checkpoint``, non-reentrant,
with the ``axis_rules`` binding carried into the recomputation):
activations are kept at layer boundaries only and recomputed in the
backward pass.

Decode caches mirror the parameter tree (``{"cycles": {"slot<i>":
stacked}, "tail": [...]}``, JAX's layout), so ``interop`` carries them
too.  They are updated in place: ``prefill`` allocates every cache at
its final size (the KV caches of global and moe layers at ``max_len``
directly, where the JAX code pads a length-T cache with
``_grow_caches``) and fills it, and
``decode_step`` writes into the caches it is given and returns them.
"""
from __future__ import annotations

import torch

from repro_torch.tree import leaves

from repro_torch.sharding.api import logical_constraint, unshard_zero

from .common import (chunked_ce_loss, embed_tokens, rms_norm, torch_dtype,
                     unembed_logits)
from .config import ArchConfig
from .layers import apply_layer, checkpointed, init_cache, init_layer


def init_params(cfg: ArchConfig, gen: torch.Generator, *,
                device=None) -> dict:
    """Random parameters drawn from ``gen``, on ``gen.device``.

    ``device="meta"`` (with a CPU ``gen``) gives the shapes and dtypes
    of a full configuration without allocating its weights.
    """
    dt = torch_dtype(cfg.dtype)
    dev = gen.device if device is None else torch.device(device)
    std = cfg.d_model ** -0.5

    def normal(shape):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return (w * std).to(dt)

    p: dict = {}
    if cfg.has_embedding:
        p["embed"] = normal((cfg.vocab, cfg.d_model))
        if not cfg.tie_embeddings:
            p["head"] = normal((cfg.d_model, cfg.vocab))
    else:
        p["adapter_in"] = normal((cfg.d_model, cfg.d_model))
        p["head"] = normal((cfg.d_model, cfg.vocab))
    p["final_norm"] = torch.zeros((cfg.d_model,), dtype=dt, device=dev)

    nc = cfg.n_cycles
    cycles: dict = {f"slot{i}": {} for i in range(len(cfg.pattern))}
    for c in range(nc):
        for i, kind in enumerate(cfg.pattern):
            layer = init_layer(cfg, kind, gen, dev)
            slot = cycles[f"slot{i}"]
            for name, w in layer.items():
                if c == 0:
                    slot[name] = torch.empty((nc,) + tuple(w.shape),
                                             dtype=w.dtype, device=dev)
                slot[name][c] = w
    p["cycles"] = cycles
    p["tail"] = [init_layer(cfg, kind, gen, dev) for kind in cfg.tail_kinds]
    return p


def _embed_inputs(cfg: ArchConfig, p: dict, inputs) -> torch.Tensor:
    if cfg.has_embedding:
        return embed_tokens(unshard_zero(p["embed"]), inputs, cfg.d_model)
    x = inputs.to(torch_dtype(cfg.dtype)) @ unshard_zero(p["adapter_in"])
    return logical_constraint(x, "batch", "seq", None)


def _run_layers(cfg: ArchConfig, p: dict, x: torch.Tensor,
                mode: str = "train", caches: dict | None = None, pos=None):
    """Cycles then tail.  Returns (x, caches): ``caches`` is None in
    train mode, else the tree ``caches`` given, updated in place."""
    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()

    def run(kind, lp, h, cache):
        def fn(h_in):
            # a ZeRO-split layer is gathered here, inside the remat
            # boundary, so one layer's full weights are live at a time
            lp_full = {k: unshard_zero(w) for k, w in lp.items()}
            return apply_layer(cfg, kind, lp_full, h_in, mode, cache,
                               pos)[0]
        if remat:
            return checkpointed(fn, h)
        return fn(h)

    slots = {i: {name: w.unbind(0)
                 for name, w in p["cycles"][f"slot{i}"].items()}
             for i in range(len(cfg.pattern))}
    for c in range(cfg.n_cycles):
        for i, kind in enumerate(cfg.pattern):
            lp = {name: ws[c] for name, ws in slots[i].items()}
            cache = None
            if caches is not None:
                cache = {name: t[c] for name, t in
                         caches["cycles"][f"slot{i}"].items()}
            x = run(kind, lp, x, cache)
    for j, kind in enumerate(cfg.tail_kinds):
        cache = None if caches is None else caches["tail"][j]
        x = run(kind, p["tail"][j], x, cache)
    return x, caches


def _head_matrix(cfg: ArchConfig, p: dict) -> torch.Tensor:
    if cfg.has_embedding and cfg.tie_embeddings:
        return unshard_zero(p["embed"]).T
    return unshard_zero(p["head"])


def forward(cfg: ArchConfig, p: dict, inputs) -> torch.Tensor:
    """Full-sequence f32 logits (small-vocab / test use; see train_loss)."""
    x = _embed_inputs(cfg, p, inputs)
    x, _ = _run_layers(cfg, p, x)
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    return unembed_logits(x, _head_matrix(cfg, p), cfg.final_softcap)


def train_loss(cfg: ArchConfig, p: dict, inputs, labels, mask=None,
               ce_chunk: int = 512) -> torch.Tensor:
    """Mean next-token (or masked-prediction) CE loss.

    inputs: (B, T) int tokens, or (B, T, D) frame embeddings when
    ``cfg.has_embedding`` is False.  labels: (B, T) int.
    """
    x = _embed_inputs(cfg, p, inputs)
    x, _ = _run_layers(cfg, p, x)
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.float32)
    return chunked_ce_loss(x, _head_matrix(cfg, p), labels, mask,
                           softcap=cfg.final_softcap, chunk=ce_chunk)


def init_decode_cache(cfg: ArchConfig, batch: int, max_len: int,
                      device=None) -> dict:
    """Initial decode caches (``init_cache`` of each layer: zeros, and
    -1e30 for the xLSTM stabilisers), stacked per slot (leading dim
    n_cycles)."""
    nc = cfg.n_cycles
    cycles = {}
    for i, kind in enumerate(cfg.pattern):
        one = init_cache(cfg, kind, batch, max_len, device=device)
        cycles[f"slot{i}"] = {
            name: t[None].expand((nc,) + tuple(t.shape)).clone()
            for name, t in one.items()}
    tail = [init_cache(cfg, kind, batch, max_len, device=device)
            for kind in cfg.tail_kinds]
    return {"cycles": cycles, "tail": tail}


def prefill(cfg: ArchConfig, p: dict, inputs, max_len: int,
            caches: dict | None = None):
    """Run the prompt, return (logits_last (B, V) f32, caches).

    Global and moe KV caches hold max(max_len, T) entries, the first T
    of them filled; local caches the last ``window`` keys; recurrent
    caches the (h, conv) state.  ``caches`` (laid out as
    ``init_decode_cache`` lays them out, e.g. placed DTensors) are
    filled instead of new ones.
    """
    assert cfg.causal, "prefill/decode only for causal LMs"
    b, t = inputs.shape[:2]
    if caches is None:
        caches = init_decode_cache(cfg, b, max(max_len, t),
                                   device=inputs.device)
    x = _embed_inputs(cfg, p, inputs)
    x, caches = _run_layers(cfg, p, x, "prefill", caches)
    x = rms_norm(x[:, -1:], p["final_norm"], cfg.norm_eps)
    logits = unembed_logits(x[:, 0], _head_matrix(cfg, p),
                            cfg.final_softcap)
    return logits, caches


def decode_step(cfg: ArchConfig, p: dict, caches: dict, tokens, pos: int):
    """One decode step.  tokens: (B,) int; pos: absolute position (int).

    Returns (logits (B, V) f32, caches), the caches updated in place.
    """
    assert cfg.causal
    x = _embed_inputs(cfg, p, tokens[:, None])
    x, caches = _run_layers(cfg, p, x, "decode", caches, int(pos))
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    logits = unembed_logits(x[:, 0], _head_matrix(cfg, p),
                            cfg.final_softcap)
    return logits, caches


def param_count(params) -> int:
    return sum(x.numel() for x in leaves(params))
