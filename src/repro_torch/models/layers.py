"""Layer kinds: the ``"global"`` attention block, in train mode.

Port of the attention part of ``repro/models/layers.py``:

    init_layer(cfg, kind, gen, device)              -> params
    apply_layer(cfg, kind, p, x, mode, cache, pos)  -> (x, new_cache)

Only ``"global"`` layers (full causal or bidirectional attention + a
dense GLU FFN) in ``mode="train"`` are ported, which covers the dense
decoders (qwen3, deepseek, chameleon) and the hubert encoder.  The
other kinds and the prefill/decode modes raise ``NotImplementedError``
until later slices port them (ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

from .common import dense_init, rms_norm, rope, torch_dtype
from .config import ArchConfig

ATTN_KINDS = ("global", "local", "moe")
# ArchConfig keeps the JAX package's impl names.
_ATTN_IMPL = {"xla": "torch", "pallas": "cuda"}


def _act(name: str):
    if name == "silu":
        return torch.nn.functional.silu
    # jax.nn.gelu defaults to the tanh approximation.
    return lambda x: torch.nn.functional.gelu(x, approximate="tanh")


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: the port covers 'global' layers in "
        "train mode; ROADMAP.md lists the slices that port the rest")


# ======================================================================
# Attention layers
# ======================================================================

def _init_attn(cfg: ArchConfig, kind: str, gen: torch.Generator,
               device=None) -> dict:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    dt = torch_dtype(cfg.dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=device)

    p = {
        "ln1": zeros(d),
        "ln2": zeros(d),
        "wq": dense_init(gen, (d, qd), dt, device=device),
        "wk": dense_init(gen, (d, kvd), dt, device=device),
        "wv": dense_init(gen, (d, kvd), dt, device=device),
        "wo": dense_init(gen, (qd, d), dt, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = zeros(cfg.head_dim)
        p["k_norm"] = zeros(cfg.head_dim)
    if cfg.post_norm:
        p["post_ln1"] = zeros(d)
        p["post_ln2"] = zeros(d)
    f = cfg.d_ff
    p["w_gate"] = dense_init(gen, (d, f), dt, device=device)
    p["w_up"] = dense_init(gen, (d, f), dt, device=device)
    p["w_down"] = dense_init(gen, (f, d), dt, device=device)
    return p


def _attention_mix(cfg: ArchConfig, kind: str, p: dict, h: torch.Tensor,
                   mode: str, cache, pos):
    """Returns (attn_out (B,T,qd), new_cache)."""
    b, t, _ = h.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = (h @ p["wq"]).reshape(b, t, hq, dh).transpose(1, 2)
    k = (h @ p["wk"]).reshape(b, t, hkv, dh).transpose(1, 2)
    v = (h @ p["wv"]).reshape(b, t, hkv, dh).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    positions = torch.arange(t, dtype=torch.int32, device=h.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = ops.attention(
        q, k, v, causal=cfg.causal, window=None, softcap=cfg.attn_softcap,
        impl=_ATTN_IMPL.get(cfg.attn_impl, cfg.attn_impl),
        block_q=cfg.block_q, block_k=cfg.block_k)
    out = out.transpose(1, 2).reshape(b, t, hq * dh)
    return out @ p["wo"], None


def _dense_ffn(cfg: ArchConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    g = _act(cfg.act)(h @ p["w_gate"]) * (h @ p["w_up"])
    return g @ p["w_down"]


def _apply_attn(cfg: ArchConfig, kind: str, p: dict, x: torch.Tensor,
                mode: str, cache, pos):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    attn, new_cache = _attention_mix(cfg, kind, p, h, mode, cache, pos)
    if cfg.post_norm:
        attn = rms_norm(attn, p["post_ln1"], cfg.norm_eps)
    x = x + attn
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    ff = _dense_ffn(cfg, p, h)
    if cfg.post_norm:
        ff = rms_norm(ff, p["post_ln2"], cfg.norm_eps)
    return x + ff, new_cache


# ======================================================================
# Dispatch
# ======================================================================

def init_layer(cfg: ArchConfig, kind: str, gen: torch.Generator,
               device=None) -> dict:
    if kind == "global":
        return _init_attn(cfg, kind, gen, device)
    if kind in ATTN_KINDS or kind in ("rglru", "mlstm", "slstm"):
        raise _unported(f"layer kind {kind!r}")
    raise ValueError(kind)


def apply_layer(cfg: ArchConfig, kind: str, p: dict, x: torch.Tensor,
                mode: str = "train", cache=None, pos=None):
    if kind == "global" and mode == "train":
        return _apply_attn(cfg, kind, p, x, mode, cache, pos)
    if kind in ATTN_KINDS or kind in ("rglru", "mlstm", "slstm"):
        raise _unported(f"layer kind {kind!r} in mode {mode!r}")
    raise ValueError(kind)
