"""Plain PyTorch versions of the kernels: the oracles and CPU paths.

Each function here computes what its counterpart in
``repro/kernels/ref.py`` computes, in straightforward tensor code.  The
CUDA wrappers (``fedavg.py``, ``quantize.py``) use them for tensors
that lie on the CPU, the tests compare them with the JAX oracles, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


# ----------------------------------------------------------------------
# Attention oracle (causal / sliding-window / softcap / GQA)
# ----------------------------------------------------------------------

def attention_mask(q_len: int, kv_len: int, *, causal: bool,
                   window: int | None, q_offset: int = 0,
                   kv_offset: int = 0, device=None) -> torch.Tensor:
    """(q_len, kv_len) bool mask.  Query i sits at absolute position
    ``q_offset + i``; key j at ``kv_offset + j`` (negative key positions
    are invalid).  ``window`` w keeps keys with
    ``q_pos - w < k_pos <= q_pos``."""
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    k_pos = kv_offset + torch.arange(kv_len, device=device)[None, :]
    mask = (k_pos >= 0).expand(q_len, kv_len)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    return mask


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int | None = None,
        softcap: float | None = None, q_offset: int = 0,
        kv_offset: int = 0, scale: float | None = None) -> torch.Tensor:
    """Reference multi-head attention, all math in f32.

    q: (B, Hq, Tq, D); k, v: (B, Hkv, Tk, D) with Hq % Hkv == 0 (GQA).
    Returns (B, Hq, Tq, D) in q.dtype.
    """
    b, hq, tq, d = q.shape
    group = hq // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    sc = (d ** -0.5) if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sc
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_mask(tq, k.shape[2], causal=causal, window=window,
                          q_offset=q_offset, kv_offset=kv_offset,
                          device=q.device)
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # Fully-masked rows (possible with windows) -> zeros, not NaN.
    p = torch.where(mask.any(-1)[None, None, :, None], p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


# ----------------------------------------------------------------------
# Masked FedAvg reduction (paper §II-B aggregation)
# ----------------------------------------------------------------------

def masked_normalized_weights(weights: torch.Tensor,
                              active: torch.Tensor) -> torch.Tensor:
    """FedAvg weights w_u m_u / sum w_u m_u, (n,) f32.

    Zero active mass (every client masked or weightless) yields zeros,
    never 0/0 NaN.  Shared by the CUDA wrapper, the plain version below
    and the torrent aggregate (dist/torrent.py).
    """
    w = weights.float() * active.float()
    total = w.sum()
    return torch.where(total > 0, w / torch.clamp(total, min=1e-12),
                       torch.zeros_like(w))


def mask_inactive_rows(updates: torch.Tensor,
                       wn: torch.Tensor) -> torch.Tensor:
    """Select out rows with zero weight BEFORE the weighted reduction.

    A masked client's update may be the reason it was masked (a
    diverged local step gives inf/NaN grads); 0 * NaN == NaN would
    poison the aggregate, so zero-weight rows are replaced, not
    multiplied.
    """
    return torch.where((wn > 0)[:, None], updates,
                       torch.zeros((), dtype=updates.dtype,
                                   device=updates.device))


def fedavg_reduce(updates: torch.Tensor, weights: torch.Tensor,
                  active: torch.Tensor) -> torch.Tensor:
    """FedAvg over the reconstructable active set.

    updates: (n, D); weights: (n,) aggregation weights; active: (n,)
    mask.  Returns (D,) = sum_u m_u w_u x_u / sum_u m_u w_u in
    ``updates.dtype``.
    """
    wn = masked_normalized_weights(weights, active)
    masked = mask_inactive_rows(updates.float(), wn)
    return torch.einsum("n,nd->d", wn, masked).to(updates.dtype)


# ----------------------------------------------------------------------
# Chunk quantization (int8 symmetric per chunk)
# ----------------------------------------------------------------------

def chunk_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (n_chunks, chunk_elems) -> (int8 codes, f32 scales (n, 1)).

    ``torch.round`` rounds half to even, as ``jnp.round`` does, and both
    divisions are true f32 divisions, so the codes equal the JAX
    oracle's bit for bit.  (On CUDA, PyTorch turns a division by a
    Python scalar into a multiplication by its reciprocal, which can be
    one ulp off; hence the 0-d tensor divisor.)
    """
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / amax.new_tensor(127.0), 1.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def chunk_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
