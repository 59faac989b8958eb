"""Implementation dispatch for the kernel package.

The ``impl=`` names follow ``repro/kernels/ops.py``:

* ``impl="cuda"``   — the hand-written Hopper kernel (where the JAX
                      package says ``"pallas"``).  Its wrapper runs the
                      plain version for tensors on the CPU and launches
                      the kernel for CUDA tensors.
* ``impl="torch"``  — plain PyTorch, blocked where the JAX ``"xla"``
                      path is blocked (attention is chunked over q).
* ``impl="ref"``    — the O(T^2) oracles in ``ref.py``.

Attention, RG-LRU and mLSTM kernels belong to later slices of the port
(ROADMAP.md, kernels #4 to #6); asking for them raises
``NotImplementedError``.
"""
from __future__ import annotations

import torch

from . import ref
from .fedavg import fedavg_reduce as _fedavg_cuda
from .quantize import chunk_dequantize as _dq_cuda
from .quantize import chunk_quantize as _q_cuda

NEG_INF = -1e30


# ----------------------------------------------------------------------
# Attention: chunked-over-q plain path
# ----------------------------------------------------------------------

def _torch_attention_qchunk(q, k, v, *, causal, window, softcap, q_offset,
                            kv_offset, scale, block_q):
    """Port of ``_xla_attention_qchunk``: peak memory O(block_q * Tk)
    per head, plain einsum and softmax in f32, GQA without repeating
    K/V (query head h reads KV head h // group)."""
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    group = hq // hkv
    sc = (d ** -0.5) if scale is None else scale
    block_q = max(1, min(block_q, tq))
    pad_q = (-tq) % block_q
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, pad_q))
    nq = q.shape[2] // block_q
    kf = k.float()
    vf = v.float()
    k_pos = kv_offset + torch.arange(tk, device=q.device)[None, :]
    outs = []
    for qi in range(nq):
        qf = q[:, :, qi * block_q:(qi + 1) * block_q].float()
        qg = qf.reshape(b, hkv, group, block_q, d)
        s = torch.einsum("bkgqd,bktd->bkgqt", qg, kf) * sc
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        q_pos = (q_offset + qi * block_q
                 + torch.arange(block_q, device=q.device))[:, None]
        mask = (k_pos >= 0).expand(block_q, tk)
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window is not None:
            mask = mask & (k_pos > q_pos - window)
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        p = torch.where(mask.any(-1)[:, None], p, 0.0)
        o = torch.einsum("bkgqt,bktd->bkgqd", p, vf)
        outs.append(o.reshape(b, hq, block_q, d))
    out = outs[0] if nq == 1 else torch.cat(outs, dim=2)
    return out[:, :, :tq].to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              softcap: float | None = None, q_offset: int = 0,
              kv_offset: int = 0, scale: float | None = None,
              impl: str = "torch", block_q: int = 512,
              block_k: int = 512) -> torch.Tensor:
    """Dispatching multi-head attention; q (B,Hq,Tq,D), k/v (B,Hkv,Tk,D)."""
    if impl == "cuda":
        raise NotImplementedError(
            "attention(impl='cuda') needs the Hopper flash_attention "
            "kernel, which the serving slice ports (ROADMAP.md, "
            "kernel #4); use impl='torch'")
    if impl == "torch":
        return _torch_attention_qchunk(q, k, v, causal=causal,
                                       window=window, softcap=softcap,
                                       q_offset=q_offset,
                                       kv_offset=kv_offset, scale=scale,
                                       block_q=block_q)
    if impl == "ref":
        return ref.mha(q, k, v, causal=causal, window=window,
                       softcap=softcap, q_offset=q_offset,
                       kv_offset=kv_offset, scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}")


def rglru(*args, **kwargs):
    raise NotImplementedError(
        "rglru is ported with the rglru_scan kernel and the recurrent "
        "layer kinds (ROADMAP.md, kernel #5)")


def mlstm(*args, **kwargs):
    raise NotImplementedError(
        "mlstm is ported with the mlstm_chunkwise kernel and the xLSTM "
        "layer kinds (ROADMAP.md, kernel #6)")


# ----------------------------------------------------------------------
# FedAvg reduction and chunk quantization
# ----------------------------------------------------------------------

def fedavg(updates: torch.Tensor, weights, active, *,
           impl: str = "torch") -> torch.Tensor:
    if impl == "cuda":
        return _fedavg_cuda(updates, weights, active)
    if impl in ("torch", "ref"):
        return ref.fedavg_reduce(
            updates, torch.as_tensor(weights, device=updates.device),
            torch.as_tensor(active, device=updates.device))
    raise ValueError(f"unknown fedavg impl {impl!r}")


def quantize(x: torch.Tensor, *, impl: str = "torch"):
    if impl == "cuda":
        return _q_cuda(x)
    if impl in ("torch", "ref"):
        return ref.chunk_quantize(x)
    raise ValueError(f"unknown quantize impl {impl!r}")


def dequantize(q: torch.Tensor, scale: torch.Tensor, *,
               impl: str = "torch", dtype=torch.float32):
    if impl == "cuda":
        return _dq_cuda(q, scale, dtype=dtype)
    if impl in ("torch", "ref"):
        return ref.chunk_dequantize(q, scale).to(dtype)
    raise ValueError(f"unknown dequantize impl {impl!r}")
