"""Layer kinds: attention (``"global"``, ``"local"``) and RG-LRU.

Port of ``repro/models/layers.py``:

    init_layer(cfg, kind, gen, device)              -> params
    apply_layer(cfg, kind, p, x, mode, cache, pos)  -> (x, new_cache)
    init_cache(cfg, kind, batch, max_len, device)   -> cache dict

``mode`` in {"train", "prefill", "decode"}: train = full sequence, no
cache; prefill = full sequence, returns a populated decode cache;
decode = one token against the cache at absolute position ``pos`` (a
Python int).  Caches for ``"local"`` layers are rolling buffers of
``window`` entries, newest last, so decode attention runs with
``kv_offset = pos - window + 1`` and negative key positions masked;
the layout is JAX's, so caches carry across the two packages.

Unlike the JAX code, caches are updated in place: prefill and decode
take the layer's cache (``model.prefill`` allocates them with
``init_cache``, global ones at ``max_len``), write the new keys/values
or recurrent state into it and return that same dict.

The ``"moe"``, ``"mlstm"`` and ``"slstm"`` kinds raise
``NotImplementedError`` until later slices port them (ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

from .common import causal_conv1d, dense_init, rms_norm, rope, torch_dtype
from .config import ArchConfig

RGLRU_C = 8.0          # Griffin's fixed recurrence constant
# ArchConfig keeps the JAX package's impl names.
_IMPL = {"xla": "torch", "pallas": "cuda"}


def _impl(name: str) -> str:
    return _IMPL.get(name, name)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation.
    return torch.nn.functional.gelu(x, approximate="tanh")


def _act(name: str):
    return torch.nn.functional.silu if name == "silu" else _gelu


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: the port covers the 'global', "
        "'local' and 'rglru' layer kinds; ROADMAP.md lists the slices "
        "that port the rest")


# ======================================================================
# Attention layers (global / local)
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


def _prefill_cache(window, k, v, cache):
    """Write what prefill leaves into ``cache``: all keys (global), or
    the last ``window`` keys left-padded with zeros (local)."""
    t = k.shape[2]
    for name, src in (("k", k), ("v", v)):
        dst = cache[name]
        if window is not None:
            n = min(t, window)
            dst[:, :, :window - n].zero_()
            dst[:, :, window - n:].copy_(src[:, :, t - n:])
        else:
            dst[:, :, :t].copy_(src)
    return cache


def _attention_mix(cfg: ArchConfig, kind: str, p: dict, h: torch.Tensor,
                   mode: str, cache, pos):
    """Returns (attn_out (B,T,qd), new_cache)."""
    b, t, _ = h.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    window = cfg.window if kind == "local" else None
    impl = _impl(cfg.attn_impl)

    q = (h @ p["wq"]).reshape(b, t, hq, dh).transpose(1, 2)
    k = (h @ p["wk"]).reshape(b, t, hkv, dh).transpose(1, 2)
    v = (h @ p["wv"]).reshape(b, t, hkv, dh).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)

    if mode == "decode":
        positions = torch.full((t,), pos, dtype=torch.int32, device=h.device)
    else:
        positions = torch.arange(t, dtype=torch.int32, device=h.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if mode == "decode":
        assert t == 1
        ck, cv = cache["k"], cache["v"]
        if window is not None:                       # rolling buffer
            ck.copy_(torch.cat([ck[:, :, 1:], k.to(ck.dtype)], dim=2))
            cv.copy_(torch.cat([cv[:, :, 1:], v.to(cv.dtype)], dim=2))
            kv_offset = pos - window + 1
        else:
            ck[:, :, pos:pos + 1] = k.to(ck.dtype)
            cv[:, :, pos:pos + 1] = v.to(cv.dtype)
            kv_offset = 0
        new_cache = cache
        out = ops.attention(
            q, ck, cv, causal=True, window=window,
            softcap=cfg.attn_softcap, q_offset=pos, kv_offset=kv_offset,
            impl=impl, block_q=cfg.block_q, block_k=cfg.block_k)
    else:
        out = ops.attention(
            q, k, v, causal=cfg.causal, window=window,
            softcap=cfg.attn_softcap, impl=impl, block_q=cfg.block_q,
            block_k=cfg.block_k)
        if mode == "prefill":
            new_cache = _prefill_cache(window, k, v, cache)

    out = out.transpose(1, 2).reshape(b, t, hq * dh)
    return out @ p["wo"], new_cache


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
# RG-LRU (Griffin recurrent block + GeGLU FFN)
# ======================================================================

def _init_rglru(cfg: ArchConfig, gen: torch.Generator, device=None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dr = cfg.d_rnn or d
    dt = torch_dtype(cfg.dtype)
    # Lambda init so a = exp(-c * softplus(lam)) ~ U(0.9, 0.999) at r=1.
    u = 0.9 + 0.099 * torch.rand((dr,), generator=gen, dtype=torch.float32,
                                 device=device)
    lam = torch.log(torch.expm1(-torch.log(u) / RGLRU_C))
    conv_w = torch.randn((cfg.conv_width, dr), generator=gen,
                         dtype=torch.float32, device=device)
    return {
        "ln1": torch.zeros((d,), dtype=dt, device=device),
        "ln2": torch.zeros((d,), dtype=dt, device=device),
        "rg_in": dense_init(gen, (d, dr), dt, device=device),
        "rg_gate": dense_init(gen, (d, dr), dt, device=device),
        "conv_w": (conv_w * cfg.conv_width ** -0.5).to(dt),
        "lam": lam,
        "a_gate_w": torch.ones((dr,), dtype=torch.float32, device=device),
        "i_gate_w": torch.ones((dr,), dtype=torch.float32, device=device),
        "rg_out": dense_init(gen, (dr, d), dt, device=device),
        "w_gate": dense_init(gen, (d, f), dt, device=device),
        "w_up": dense_init(gen, (d, f), dt, device=device),
        "w_down": dense_init(gen, (f, d), dt, device=device),
    }


def _apply_rglru(cfg: ArchConfig, p: dict, x: torch.Tensor, mode: str,
                 cache, pos):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    xr = h @ p["rg_in"]
    xg = _gelu(h @ p["rg_gate"])
    conv_state = cache["conv"] if mode == "decode" else None
    xc, new_conv = causal_conv1d(xr, p["conv_w"], conv_state)

    xcf = xc.float()
    r = torch.sigmoid(xcf * p["a_gate_w"])
    i = torch.sigmoid(xcf * p["i_gate_w"])
    # jax.nn.softplus is logaddexp(x, 0)
    softplus = torch.logaddexp(p["lam"], torch.zeros_like(p["lam"]))
    a = torch.exp(-RGLRU_C * softplus * r)
    h0 = cache["h"] if mode == "decode" else None
    y, h_t = ops.rglru(xc, a.to(xc.dtype), i.to(xc.dtype), h0,
                       impl=_impl(cfg.rnn_impl))
    x = x + (xg * y) @ p["rg_out"]
    hh = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + _dense_ffn(cfg, p, hh)
    if mode in ("decode", "prefill"):
        cache["h"].copy_(h_t)
        cache["conv"].copy_(new_conv)
    return x, cache


# ======================================================================
# Dispatch
# ======================================================================

def init_layer(cfg: ArchConfig, kind: str, gen: torch.Generator,
               device=None) -> dict:
    if kind in ("global", "local"):
        return _init_attn(cfg, kind, gen, device)
    if kind == "rglru":
        return _init_rglru(cfg, gen, device)
    if kind in ("moe", "mlstm", "slstm"):
        raise _unported(f"layer kind {kind!r}")
    raise ValueError(kind)


def apply_layer(cfg: ArchConfig, kind: str, p: dict, x: torch.Tensor,
                mode: str = "train", cache=None, pos=None):
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    if kind in ("global", "local"):
        return _apply_attn(cfg, kind, p, x, mode, cache, pos)
    if kind == "rglru":
        return _apply_rglru(cfg, p, x, mode, cache, pos)
    if kind in ("moe", "mlstm", "slstm"):
        raise _unported(f"layer kind {kind!r}")
    raise ValueError(kind)


def init_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
               dtype=None, device=None) -> dict:
    """Zeroed decode cache of one layer, as ``repro`` lays it out."""
    dt = dtype or torch_dtype(cfg.dtype)
    if kind in ("global", "local"):
        cdt = dtype or torch_dtype(cfg.cache_dtype or cfg.dtype)
        size = cfg.window if kind == "local" else max_len
        shape = (batch, cfg.n_kv, size, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=cdt, device=device),
                "v": torch.zeros(shape, dtype=cdt, device=device)}
    if kind == "rglru":
        dr = cfg.d_rnn or cfg.d_model
        return {"h": torch.zeros((batch, dr), dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros((batch, cfg.conv_width - 1, dr),
                                    dtype=dt, device=device)}
    if kind in ("moe", "mlstm", "slstm"):
        raise _unported(f"the decode cache of layer kind {kind!r}")
    raise ValueError(kind)
