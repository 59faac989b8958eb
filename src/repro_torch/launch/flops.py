"""Analytic MODEL_FLOPS per cell (the roofline's 'useful compute' term).

Port of ``repro/launch/flops.py``, the same formulas: MODEL_FLOPS =
6*N*D for training (fwd+bwd), 2*N*D for forward-only (prefill), 2*N*B
per decoded token, with N = active parameter count (MoE: top-k experts
only).  Attention score/value FLOPs are added explicitly, since at 32k
context they are a material fraction (4*pairs*d_head*H per sequence
forward, pairs halved for the causal triangle, banded for local
layers; recurrent layers are counted through their parameters).  It is
the numerator of a whole-step MFU.
"""
from __future__ import annotations

from repro_torch.configs.base import ShapeSpec
from repro_torch.models import ArchConfig


def _layer_kinds(cfg: ArchConfig) -> list:
    return (list(cfg.pattern) * cfg.n_cycles) + list(cfg.tail_kinds)


def _attn_flops_per_seq(cfg: ArchConfig, t: int) -> float:
    """Score+value matmul FLOPs for ONE sequence of length t (fwd)."""
    total = 0.0
    for k in _layer_kinds(cfg):
        if k in ("global", "moe"):
            pairs = t * t / 2 if cfg.causal else t * t
        elif k == "local":
            w = cfg.window or t
            pairs = min(w, t) * t        # banded
        else:
            continue                     # recurrent: counted via params
        total += 4.0 * pairs * cfg.n_heads * cfg.head_dim
    return total


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """Useful FLOPs of one step of ``shape`` over the global batch."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return (6.0 * n_active * tokens
                + 3.0 * shape.global_batch * _attn_flops_per_seq(
                    cfg, shape.seq_len))
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return (2.0 * n_active * tokens
                + shape.global_batch * _attn_flops_per_seq(
                    cfg, shape.seq_len))
    # decode: one token against a seq_len cache
    attn = 0.0
    for k in _layer_kinds(cfg):
        if k in ("global", "moe"):
            span = shape.seq_len
        elif k == "local":
            span = min(cfg.window or shape.seq_len, shape.seq_len)
        else:
            continue
        attn += 4.0 * span * cfg.n_heads * cfg.head_dim
    return shape.global_batch * (2.0 * n_active + attn)


__all__ = ["model_flops"]
