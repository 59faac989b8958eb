"""Model FLOPs of a training step: a frozen copy of the program's
``launch/flops.py::model_flops`` (train kind) and of
``models/config.py``'s parameter counts, over a configuration's
``arch`` dict.  6 * N_active * tokens, plus the attention products
(4 * pairs * head_dim * heads a sequence forward, the causal triangle
halved, a window banded), three times for forward and backward."""
from __future__ import annotations

import math


def _kinds(a: dict) -> list:
    pat = list(a.get("pattern", ["global"]))
    n = a["n_layers"]
    return pat * (n // len(pat)) + pat[: n % len(pat)]


def _layer_params(a: dict, kind: str) -> int:
    d = a["d_model"]
    qd = a["n_heads"] * a["head_dim"]
    kvd = a["n_kv"] * a["head_dim"]
    n = 0
    if kind in ("global", "local", "moe"):
        n += d * (qd + 2 * kvd) + qd * d
        n += 2 * d
        if a.get("post_norm"):
            n += 2 * d
        if a.get("qk_norm"):
            n += 2 * a["head_dim"]
        if kind == "moe":
            n += d * a["n_experts"]
            n += a["n_experts"] * 3 * d * a["d_expert"]
        else:
            n += 3 * d * a["d_ff"]
    elif kind == "rglru":
        dr = a.get("d_rnn") or d
        n += 2 * d + 2 * d * dr + a.get("conv_width", 4) * dr + 3 * dr
        n += 2 * dr * d + 3 * d * a["d_ff"]
    elif kind == "mlstm":
        di = 2 * d
        h = max(a.get("rnn_heads", 0), 1)
        n += d + 2 * d * di + a.get("conv_width", 4) * di
        n += 3 * di * di // h * h + 3 * di + di * d
    elif kind == "slstm":
        h = a.get("rnn_heads") or 4
        dh = d // h
        n += d + 4 * d * d + 4 * h * dh * dh + 4 * d
        n += 2 * d * math.ceil(4 * d / 3) // 1
    else:
        raise ValueError(kind)
    return int(n)


def param_count(a: dict) -> int:
    d, v = a["d_model"], a["vocab"]
    total = v * d * (1 if a.get("tie_embeddings", True) else 2)
    total += d
    return total + sum(_layer_params(a, k) for k in _kinds(a))


def active_param_count(a: dict) -> int:
    total = param_count(a)
    if not a.get("n_experts"):
        return total
    n_moe = sum(1 for k in _kinds(a) if k == "moe")
    per = 3 * a["d_model"] * a["d_expert"]
    return int(total - n_moe * (a["n_experts"] - a["top_k"]) * per)


def _attn_flops_per_seq(a: dict, t: int) -> float:
    total = 0.0
    for k in _kinds(a):
        if k in ("global", "moe"):
            pairs = t * t / 2 if a.get("causal", True) else t * t
        elif k == "local":
            pairs = min(a.get("window") or t, t) * t
        else:
            continue
        total += 4.0 * pairs * a["n_heads"] * a["head_dim"]
    return total


def train_flops(a: dict, batch: int, seq: int) -> float:
    """Useful FLOPs of one training step over ``batch`` sequences."""
    return (6.0 * active_param_count(a) * batch * seq
            + 3.0 * batch * _attn_flops_per_seq(a, seq))
