"""Per-chunk int8 symmetric quantize / dequantize: CUDA wrappers.

The torrent collective's wire compression (``dist/torrent.py``): each
block of the flattened update is sent as int8 codes plus one f32 scale,
``scale = amax / 127`` (1 for an all-zero block) and
``q = clip(round(x / scale), -127, 127)``.  The kernels in
``csrc/quantize.cu`` replace the Pallas TPU kernels
``repro/kernels/quantize.py::chunk_quantize`` and ``chunk_dequantize``;
their codes and scales equal the plain versions' bit for bit.

For tensors on the CPU the wrappers run the plain versions in
``ref.py``; for CUDA tensors they launch the kernels or raise.
"""
from __future__ import annotations

import torch

from . import _build, ref

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _check_2d(name: str, t: torch.Tensor, dtype) -> tuple[int, int]:
    if t.dim() != 2 or t.dtype != dtype:
        raise ValueError(f"{name}: expected a 2-D {dtype} tensor, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    n, e = t.shape
    if e == 0:
        raise ValueError(f"{name}: rows must not be empty")
    return n, e


def chunk_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (n_chunks, E) f32 -> (int8 codes (n, E), f32 scales (n, 1))."""
    if _build.plain_route(x):
        return ref.chunk_quantize(x)
    _build.require_cuda("chunk_quantize", x)
    n, e = _check_2d("chunk_quantize", x, torch.float32)
    ext = _build.extension()
    q = torch.empty((n, e), dtype=torch.int8, device=x.device)
    scale = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    partial = torch.empty((n, ext.chunk_tiles(n, e)), dtype=torch.float32,
                          device=x.device)
    ext.chunk_quantize(x, q, scale, partial)
    _build.LAUNCHES["chunk_quantize"] += 1
    return q, scale


def chunk_dequantize(q: torch.Tensor, scale: torch.Tensor, *,
                     dtype=torch.float32,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """(n, E) int8 + (n, 1) scales -> (n, E) ``dtype``.

    ``out``, when given, receives the result in place; the torrent
    round trip writes back into the f32 buffer it quantized, so the
    full-width step holds no second copy of the update.
    """
    if out is not None:
        dtype = out.dtype
    if _build.plain_route(q):
        res = ref.chunk_dequantize(q, scale).to(dtype)
        return res if out is None else out.copy_(res)
    _build.require_cuda("chunk_dequantize", q, scale,
                        *(() if out is None else (out,)))
    n, e = _check_2d("chunk_dequantize", q, torch.int8)
    if scale.dtype != torch.float32 or scale.numel() != n:
        raise ValueError(f"chunk_dequantize: scale must hold {n} float32, "
                         f"got {tuple(scale.shape)} {scale.dtype}")
    if dtype not in _OUT_DTYPES:
        raise ValueError(f"chunk_dequantize: dtype must be float32 or "
                         f"bfloat16, got {dtype}")
    if out is None:
        out = torch.empty((n, e), dtype=dtype, device=q.device)
    elif out.shape != q.shape or not out.is_contiguous():
        raise ValueError(f"chunk_dequantize: out must be a contiguous "
                         f"{tuple(q.shape)} tensor")
    _build.extension().chunk_dequantize(q, scale.contiguous(), out)
    _build.LAUNCHES["chunk_dequantize"] += 1
    return out
