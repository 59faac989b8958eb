"""Masked FedAvg reduction over stacked client updates: CUDA wrapper.

The paper's aggregation step (§II-B): every client computes

    agg = sum_u  m_u * w_u * x_u  /  sum_u m_u * w_u

over the updates ``x_u`` it reconstructed, where ``m_u`` is the
active-set mask and ``w_u`` the published weight.  The mask x weight
vector is normalised once here, on the device (O(n)); the kernel in
``csrc/fedavg.cu`` streams the (n, D) updates once and selects out
rows whose weight is zero.  It replaces the Pallas TPU kernel
``repro/kernels/fedavg.py::fedavg_reduce``.

For a tensor on the CPU the wrapper runs the plain version in
``ref.py``; for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build, ref
from .ref import mask_inactive_rows, masked_normalized_weights

__all__ = ["fedavg_reduce", "masked_normalized_weights",
           "mask_inactive_rows"]

_DTYPES = (torch.float32, torch.bfloat16)


def fedavg_reduce(updates: torch.Tensor, weights, active) -> torch.Tensor:
    """updates (n, D); weights (n,); active (n,) -> (D,) FedAvg, in
    ``updates.dtype`` and accumulated in f32."""
    weights = torch.as_tensor(weights, device=updates.device)
    active = torch.as_tensor(active, device=updates.device)
    if _build.plain_route(updates):
        return ref.fedavg_reduce(updates, weights, active)
    _build.require_cuda("fedavg_reduce", updates, weights, active)
    if updates.dim() != 2:
        raise ValueError(f"fedavg_reduce: updates must be (n, D), got "
                         f"{tuple(updates.shape)}")
    n, d = updates.shape
    if weights.shape != (n,) or active.shape != (n,):
        raise ValueError(f"fedavg_reduce: weights and active must be ({n},)"
                         f", got {tuple(weights.shape)} and "
                         f"{tuple(active.shape)}")
    if updates.dtype not in _DTYPES:
        raise ValueError(f"fedavg_reduce: updates must be float32 or "
                         f"bfloat16, got {updates.dtype}")
    if not updates.is_contiguous():
        raise ValueError("fedavg_reduce: updates must be contiguous")
    wn = masked_normalized_weights(weights, active).contiguous()
    out = torch.empty((d,), dtype=updates.dtype, device=updates.device)
    _build.extension().fedavg_reduce(updates, wn, out)
    _build.LAUNCHES["fedavg_reduce"] += 1
    return out
