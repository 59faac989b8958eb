"""RG-LRU gated diagonal linear recurrence: CUDA wrapper.

    h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * (gx_t * x_t)

recurrentgemma's recurrent block (De et al., "Griffin", 2024).  The
kernel in ``csrc/rglru.cu`` replaces the Pallas TPU kernel
``repro/kernels/rglru.py::rglru_scan``: one thread per (b, d) channel
carries ``h`` in a register through a loop over T.

For tensors on the CPU the wrapper runs the plain version
(``ref.rglru``, a sequential f32 loop); for CUDA tensors it launches
the kernel or raises.  Like the Pallas kernel it has no gradient:
``ops.rglru(impl="cuda")`` raises when one is asked for, and training
uses ``impl="torch"``.
"""
from __future__ import annotations

import torch

from . import _build, ref

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535


def rglru_scan(x: torch.Tensor, a: torch.Tensor, gate_x: torch.Tensor,
               h0: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """x, a, gate_x (B, T, D); h0 (B, D) f32 or None -> (y (B, T, D) in
    ``x.dtype``, h_T (B, D) f32)."""
    if x.device.type == "cpu":
        return ref.rglru(x, a, gate_x, h0)
    _build.require_cuda("rglru_scan", x, a, gate_x,
                        *(() if h0 is None else (h0,)))
    if x.dim() != 3 or a.shape != x.shape or gate_x.shape != x.shape:
        raise ValueError(f"rglru_scan: x, a, gate_x must share one "
                         f"(B, T, D) shape, got {tuple(x.shape)}, "
                         f"{tuple(a.shape)}, {tuple(gate_x.shape)}")
    if x.dtype not in _DTYPES or a.dtype != x.dtype or gate_x.dtype != x.dtype:
        raise ValueError(f"rglru_scan: x, a, gate_x must share float32 or "
                         f"bfloat16, got {x.dtype}, {a.dtype}, "
                         f"{gate_x.dtype}")
    b, t, d = x.shape
    if b > _MAX_GRID_Y:
        raise ValueError(f"rglru_scan: B must be at most {_MAX_GRID_Y}, "
                         f"got {b}")
    if h0 is not None:
        if h0.shape != (b, d) or h0.dtype != torch.float32:
            raise ValueError(f"rglru_scan: h0 must be ({b}, {d}) float32, "
                             f"got {tuple(h0.shape)} {h0.dtype}")
        h0 = h0.contiguous()
    x, a, gate_x = x.contiguous(), a.contiguous(), gate_x.contiguous()
    y = torch.empty_like(x)
    h_last = torch.empty((b, d), dtype=torch.float32, device=x.device)
    _build.extension().rglru_scan(x, a, gate_x, h0, y, h_last)
    _build.LAUNCHES["rglru_scan"] += 1
    return y, h_last
