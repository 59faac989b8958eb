"""Implementation dispatch for the kernel package.

The ``impl=`` names follow ``repro/kernels/ops.py``:

* ``impl="cuda"``   — the hand-written Hopper kernel (where the JAX
                      package says ``"pallas"``).  Its wrapper runs the
                      plain version for tensors on the CPU and launches
                      the kernel for CUDA tensors.
* ``impl="torch"``  — plain PyTorch, blocked where the JAX ``"xla"``
                      path is blocked (attention is chunked over q;
                      rglru is a log-depth scan; mlstm is chunkwise),
                      and differentiable.
* ``impl="ref"``    — the oracles in ``ref.py`` (O(T^2) attention,
                      the sequential rglru loop, the chunkwise mlstm).

JAX's two-block sliding-window path (``_xla_attention_swa``) is not
ported: ``impl="torch"`` computes the same function with the q-chunked
path.
"""
from __future__ import annotations

import torch

from . import ref
from .attention import flash_attention as _flash_cuda
from .fedavg import fedavg_reduce as _fedavg_cuda
from .mlstm import mlstm_chunkwise as _mlstm_cuda
from .quantize import chunk_dequantize as _dq_cuda
from .quantize import chunk_quantize as _q_cuda
from .rglru import rglru_scan as _rglru_cuda


# ----------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """The kernel forward; the backward recomputes through the plain
    chunked path, as ``_pallas_attention``'s ``custom_vjp`` does."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        ctx.save_for_backward(q, k, v)
        ctx.kw = kw
        return _flash_cuda(q, k, v, **kw)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            req = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = ref.attention_qchunk(*req, **ctx.kw)
            grads = torch.autograd.grad(out, req, g)
        return (*grads, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              softcap: float | None = None, q_offset: int = 0,
              kv_offset: int = 0, scale: float | None = None,
              impl: str = "torch", block_q: int = 512,
              block_k: int = 512) -> torch.Tensor:
    """Dispatching multi-head attention; q (B,Hq,Tq,D), k/v (B,Hkv,Tk,D).

    ``block_k`` is kept for the JAX signature; the kernel's KV tile is
    fixed (``csrc/attention.cu``) and the plain path does not tile K.
    """
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset, kv_offset=kv_offset, scale=scale,
              block_q=block_q)
    if impl == "cuda":
        return _FlashAttention.apply(q, k, v, kw)
    if impl == "torch":
        return ref.attention_qchunk(q, k, v, **kw)
    if impl == "ref":
        kw.pop("block_q")
        return ref.mha(q, k, v, **kw)
    raise ValueError(f"unknown attention impl {impl!r}")


# ----------------------------------------------------------------------
# RG-LRU
# ----------------------------------------------------------------------

def _torch_rglru(x, a, gate_x, h0):
    """Port of ``_xla_rglru``: an inclusive scan over T of the affine
    maps h -> a h + b in log2(T) doubling steps (Hillis-Steele; JAX's
    ``associative_scan`` combines in another order), out of place, so
    autograd differentiates it.  f32 throughout."""
    xf, af, gx = x.float(), a.float(), gate_x.float()
    bv = torch.sqrt(torch.clamp(1.0 - af * af, min=0.0)) * (gx * xf)
    if h0 is not None:
        # Fold h0 into the first step: h_1 = a_1 h_0 + i_1.
        first = bv[:, :1] + af[:, :1] * h0.float()[:, None]
        bv = torch.cat([first, bv[:, 1:]], dim=1)
    av = af
    t = x.shape[1]
    shift = 1
    while shift < t:
        a_prev = torch.nn.functional.pad(av[:, :-shift], (0, 0, shift, 0),
                                         value=1.0)
        b_prev = torch.nn.functional.pad(bv[:, :-shift], (0, 0, shift, 0))
        bv = b_prev * av + bv
        av = a_prev * av
        shift *= 2
    return bv.to(x.dtype), bv[:, -1]


def rglru(x: torch.Tensor, a: torch.Tensor, gate_x: torch.Tensor,
          h0: torch.Tensor | None = None, *, impl: str = "torch"):
    """Gated diagonal linear recurrence; returns (y (B,T,D), h_T (B,D)).

    ``impl="cuda"`` is the ``rglru_scan`` kernel (the plain loop for CPU
    tensors).  Like the Pallas kernel it has no gradient: it raises when
    an input requires one; train with ``impl="torch"``.
    """
    if impl == "cuda":
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (x, a, gate_x, h0)):
            raise RuntimeError(
                "rglru(impl='cuda') has no gradient, as the Pallas "
                "rglru_scan has none; use impl='torch' to train")
        return _rglru_cuda(x, a, gate_x, h0)
    if impl == "torch":
        return _torch_rglru(x, a, gate_x, h0)
    if impl == "ref":
        return ref.rglru(x, a, gate_x, h0)
    raise ValueError(f"unknown rglru impl {impl!r}")


class _MlstmChunkwise(torch.autograd.Function):
    """The kernel forward; no backward, as the Pallas kernel has no VJP."""

    @staticmethod
    def forward(ctx, q, k, v, i_pre, f_pre, chunk):
        return _mlstm_cuda(q, k, v, i_pre, f_pre, chunk=chunk)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            "mlstm(impl='cuda') has no gradient, as the Pallas "
            "mlstm_chunkwise has none; use impl='torch' to train (the "
            "layers' train mode does)")


def mlstm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          i_pre: torch.Tensor, f_pre: torch.Tensor, *, chunk: int = 128,
          impl: str = "torch"):
    """Chunkwise-parallel mLSTM from a zero state.

    q, k, v: (B, H, T, dh) (q, k pre-scaled); i_pre, f_pre: (B, H, T).
    Returns (h (B, H, T, dh), C, n, m).  ``impl="cuda"`` is the
    ``mlstm_chunkwise`` kernel (the plain version for CPU tensors),
    which needs T to be a multiple of ``chunk``; ``"torch"`` and
    ``"ref"`` are the plain chunkwise form, which pads T itself, as
    JAX's ``impl="xla"`` does.
    """
    if impl == "cuda":
        return _MlstmChunkwise.apply(q, k, v, i_pre, f_pre, chunk)
    if impl in ("torch", "ref"):
        return ref.mlstm_chunkwise(q, k, v, i_pre, f_pre, chunk=chunk)
    raise ValueError(f"unknown mlstm impl {impl!r}")


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
