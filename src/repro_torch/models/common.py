"""Shared model components: norms, RoPE, embeddings, chunked CE loss,
the depthwise causal conv of the recurrent block.

Port of ``repro/models/common.py``.  The numerics follow the JAX code:
norms and RoPE in f32 and cast back, the embedding scale rounded to the
activation dtype first, and logits in f32 computed from the bf16
operands (the JAX dot's ``preferred_element_type=float32``), never a
bf16 product upcast afterwards.  ``logical_constraint`` has no
counterpart: the port shards nothing.
"""
from __future__ import annotations

import math

import torch


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype an ``ArchConfig`` dtype name stands for."""
    return getattr(torch, name)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Half-split rotary embedding.  x: (B, H, T, D); positions: (T,)
    or (B, T) absolute positions."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    if positions.dim() == 1:
        ang = positions.float()[:, None] * freq[None, :]
        ang = ang[None, None]                       # (1, 1, T, half)
    else:
        ang = positions.float()[:, None, :, None] * freq
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor,
                 d_model: int) -> torch.Tensor:
    x = embed[tokens]
    return x * torch.tensor(math.sqrt(d_model), dtype=x.dtype,
                            device=x.device)


def unembed_logits(x: torch.Tensor, embed_t: torch.Tensor,
                   softcap: float | None) -> torch.Tensor:
    """x: (..., D) @ embed_t (D, V) -> f32 logits, optional softcap."""
    logits = torch.matmul(x.float(), embed_t.float())
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def chunked_ce_loss(x: torch.Tensor, embed_t: torch.Tensor,
                    labels: torch.Tensor, mask: torch.Tensor, *,
                    softcap: float | None, chunk: int = 512
                    ) -> torch.Tensor:
    """Cross-entropy without materialising full (B, T, V) logits.

    x: (B, T, D) final hidden states; embed_t: (D, V); labels: (B, T)
    int; mask: (B, T) float (0 = ignore).  Logits are computed one
    T-chunk at a time, so peak memory is (B, chunk, V).
    """
    b, t, _ = x.shape
    chunk = max(1, min(chunk, t))
    pad = (-t) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    labels = labels.long()
    losses, counts = [], []
    for c in range(x.shape[1] // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        logits = unembed_logits(x[:, sl], embed_t, softcap)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, sl, None])[..., 0]
        mb = mask[:, sl]
        losses.append(((lse - gold) * mb).sum())
        counts.append(mb.sum())
    return (torch.stack(losses).sum()
            / torch.clamp(torch.stack(counts).sum(), min=1.0))


# ----------------------------------------------------------------------
# Initializers
# ----------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype, in_axis: int = 0,
               device=None) -> torch.Tensor:
    """Normal(0, fan_in^-1/2) drawn in f32 from ``gen``, cast to dtype."""
    std = shape[in_axis] ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (w * std).to(dtype)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: torch.Tensor | None = None):
    """Depthwise causal conv.  x: (B, T, D); w: (W, D).

    Returns (y (B, T, D), new_state (B, W-1, D)): the state carries the
    last W-1 inputs for decode continuation.  The taps are summed in
    ``x.dtype`` in the JAX code's order.
    """
    width = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    t = x.shape[1]
    y = sum(xp[:, i:i + t] * w[i] for i in range(width))
    new_state = xp[:, xp.shape[1] - (width - 1):]
    return y.to(x.dtype), new_state
