"""Unified LM: init / forward / train loss.

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
(``torch.utils.checkpoint``, non-reentrant): activations are kept at
layer boundaries only and recomputed in the backward pass.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.tree import leaves

from .common import (chunked_ce_loss, embed_tokens, rms_norm, torch_dtype,
                     unembed_logits)
from .config import ArchConfig
from .layers import apply_layer, init_layer


def init_params(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """Random parameters drawn from ``gen``, on ``gen.device``."""
    dt = torch_dtype(cfg.dtype)
    dev = gen.device
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
        return embed_tokens(p["embed"], inputs, cfg.d_model)
    return inputs.to(torch_dtype(cfg.dtype)) @ p["adapter_in"]


def _run_layers(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Cycles then tail, in train mode."""
    remat = cfg.remat and torch.is_grad_enabled()

    def run(kind, lp, h):
        def fn(h_in):
            return apply_layer(cfg, kind, lp, h_in, "train")[0]
        if remat:
            return checkpoint(fn, h, use_reentrant=False)
        return fn(h)

    slots = {i: {name: w.unbind(0)
                 for name, w in p["cycles"][f"slot{i}"].items()}
             for i in range(len(cfg.pattern))}
    for c in range(cfg.n_cycles):
        for i, kind in enumerate(cfg.pattern):
            lp = {name: ws[c] for name, ws in slots[i].items()}
            x = run(kind, lp, x)
    for j, kind in enumerate(cfg.tail_kinds):
        x = run(kind, p["tail"][j], x)
    return x


def _head_matrix(cfg: ArchConfig, p: dict) -> torch.Tensor:
    if cfg.has_embedding and cfg.tie_embeddings:
        return p["embed"].T
    return p["head"]


def forward(cfg: ArchConfig, p: dict, inputs) -> torch.Tensor:
    """Full-sequence f32 logits (small-vocab / test use; see train_loss)."""
    x = _embed_inputs(cfg, p, inputs)
    x = _run_layers(cfg, p, x)
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    return unembed_logits(x, _head_matrix(cfg, p), cfg.final_softcap)


def train_loss(cfg: ArchConfig, p: dict, inputs, labels, mask=None,
               ce_chunk: int = 512) -> torch.Tensor:
    """Mean next-token (or masked-prediction) CE loss.

    inputs: (B, T) int tokens, or (B, T, D) frame embeddings when
    ``cfg.has_embedding`` is False.  labels: (B, T) int.
    """
    x = _embed_inputs(cfg, p, inputs)
    x = _run_layers(cfg, p, x)
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    return chunked_ce_loss(x, _head_matrix(cfg, p), labels, mask,
                           softcap=cfg.final_softcap, chunk=ce_chunk)


def param_count(params) -> int:
    return sum(x.numel() for x in leaves(params))
