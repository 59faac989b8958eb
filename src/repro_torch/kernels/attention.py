"""Flash attention forward (causal / window / softcap / GQA): CUDA wrapper.

The kernel in ``csrc/attention.cu`` replaces the Pallas TPU kernel
``repro/kernels/attention.py::flash_attention``: one CTA per (batch,
query head, tile of 64 query rows) loops over the live KV tiles with
an online softmax in f32, skipping every tile the causal mask, the
window or the rolling cache's negative key positions rule out.

``q_offset`` is the absolute position of query row 0 and ``kv_offset``
that of key 0 (negative in a rolling decode cache, whose first entries
are then masked).  For tensors on the CPU the wrapper runs the plain
version (``ref.attention_qchunk``); for CUDA tensors it launches the
kernel or raises.  It has no backward of its own: ``ops.attention``
wraps it in a ``torch.autograd.Function`` that recomputes through the
plain version, as JAX's ``custom_vjp`` does.
"""
from __future__ import annotations

import torch

from . import _build, ref

HEAD_DIMS = (16, 32, 64, 80, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned start (the kernel reads 16 or
    8 bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, q_offset: int = 0,
                    kv_offset: int = 0, scale: float | None = None,
                    block_q: int = 512) -> torch.Tensor:
    """q (B, Hq, Tq, D); k, v (B, Hkv, Tk, D) -> (B, Hq, Tq, D) in
    ``q.dtype``.  ``block_q`` sizes only the plain version's chunks."""
    if q.device.type == "cpu":
        return ref.attention_qchunk(q, k, v, causal=causal, window=window,
                                    softcap=softcap, q_offset=q_offset,
                                    kv_offset=kv_offset, scale=scale,
                                    block_q=block_q)
    _build.require_cuda("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q must be (B, Hq, Tq, D) and "
                         f"k, v (B, Hkv, Tk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, tq, d = q.shape
    _, hkv, tk, dk = k.shape
    if k.shape[0] != b or dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match (GQA needs "
                         f"Hq % Hkv == 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} is not one of "
                         f"{HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share float32 or "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if b > _MAX_GRID_YZ or hq > _MAX_GRID_YZ:
        raise ValueError(f"flash_attention: B and Hq must be at most "
                         f"{_MAX_GRID_YZ}, got {b} and {hq}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap must be positive, got "
                         f"{softcap}")
    if window is not None and window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got "
                         f"{window}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    _build.extension().flash_attention(
        q, k, v, out, bool(causal), -1 if window is None else int(window),
        0.0 if softcap is None else float(softcap), int(q_offset),
        int(kv_offset), float(d ** -0.5 if scale is None else scale))
    _build.LAUNCHES["flash_attention"] += 1
    return out
