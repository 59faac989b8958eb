"""Shared model components: norms, RoPE, embeddings, chunked CE loss,
the depthwise causal conv of the recurrent block.

Port of ``repro/models/common.py``.  The numerics follow the JAX code:
norms and RoPE in f32 and cast back, the embedding scale rounded to the
activation dtype first, and logits in f32 computed from the bf16
operands (the JAX dot's ``preferred_element_type=float32``), never a
bf16 product upcast afterwards.

``logical_constraint`` pins the embeddings to ("batch", "seq", None),
as in JAX; it redistributes DTensors and leaves plain tensors alone.
Given DTensor parameters (the dry run, the placed FL step) the loss
runs vocabulary-parallel over the ``model`` axis
(``_ce_vocab_parallel``), where JAX constrains the logits to
``vocab``.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.sharding.api import (constrain, is_dtensor,
                                      logical_constraint, placements_like,
                                      replicate_like)


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
    sin = replicate_like(torch.sin(ang), x)
    cos = replicate_like(torch.cos(ang), x)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor,
                 d_model: int) -> torch.Tensor:
    if is_dtensor(embed):
        # the vocabulary split's masked lookup, summed here over model
        # (whatever the rules: the partial sum holds its mask only until
        # the next op)
        x = torch.nn.functional.embedding(tokens, embed)
        x = constrain(x, placements_like(x, 0, None))
    else:
        x = embed[tokens]
    x = x * torch.tensor(math.sqrt(d_model), dtype=x.dtype,
                         device=x.device)
    return logical_constraint(x, "batch", "seq", None)


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
    if is_dtensor(embed_t):
        return _ce_vocab_parallel(x, embed_t, labels, mask,
                                  softcap=softcap, chunk=chunk)
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


class _CopyToGroup(torch.autograd.Function):
    """A replicated input that every rank of ``group`` uses: the forward
    is the identity, the backward sums the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """Partial outputs of ``group``'s ranks summed: the forward is an
    ``all_reduce``, the backward the identity (every rank then holds the
    same sum and receives the same gradient)."""

    @staticmethod
    def forward(ctx, y, group):
        y = y.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _ce_vocab_parallel(x, embed_t, labels, mask, *, softcap, chunk):
    """``chunked_ce_loss`` over DTensors, the vocabulary split over the
    mesh's ``model`` axis where it divides (Megatron's
    vocabulary-parallel loss).

    Each rank computes the logits of its slice of the vocabulary for its
    batch shard, one T-chunk at a time; the log-sum-exp takes the max
    and the sum of exponentials over the ``model`` group, the gold logit
    is the one rank's that holds the label.  No rank holds a full row of
    logits.  Returns the mean loss as a replicated DTensor.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    tm = x.device_mesh
    names = tuple(tm.mesh_dim_names)
    batch = tuple(Shard(0) if (n != "model" and pl == Shard(0))
                  else Replicate() for n, pl in zip(names, x.placements))
    # the vocabulary on model where it divides, as JAX's constraint to
    # "vocab" filters it; else every model rank holds all of it
    split = "model" in names and embed_t.shape[1] % tm.size(
        names.index("model")) == 0
    w_pl = tuple(Shard(1) if (n == "model" and split) else Replicate()
                 for n in names)
    # the weight's gradient: each rank's own vocabulary slice, summed
    # over the ranks of a batch split
    varies = tuple(p if n == "model" else
                   Partial() if b == Shard(0) else p
                   for n, b, p in zip(names, batch, w_pl))
    xl = x.redistribute(tm, batch).to_local()
    wl = embed_t.redistribute(tm, w_pl).to_local(grad_placements=varies)
    ll = labels.redistribute(tm, batch).to_local() if is_dtensor(labels) \
        else labels
    ml = mask.redistribute(tm, batch).to_local() if is_dtensor(mask) \
        else mask
    if split:
        grp = tm.get_group("model")
        lo = tm.get_local_rank("model") * wl.shape[1]
        xl = _CopyToGroup.apply(xl, grp)
    else:
        grp, lo = None, 0
    v_loc = wl.shape[1]
    losses, counts = [], []
    for c in range(xl.shape[1] // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        logits = unembed_logits(xl[:, sl], wl, softcap)
        m = logits.detach().amax(-1)
        if grp is not None:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=grp)
        se = torch.exp(logits - m[..., None]).sum(-1)
        lab = ll[:, sl] - lo
        mine = (lab >= 0) & (lab < v_loc)
        gold = torch.gather(logits, -1, torch.where(mine, lab, 0)[..., None])
        gold = torch.where(mine, gold[..., 0], 0.0)
        if grp is not None:
            se = _ReduceFromGroup.apply(se, grp)
            gold = _ReduceFromGroup.apply(gold, grp)
        lse = m + torch.log(se)
        mb = ml[:, sl]
        losses.append(((lse - gold) * mb).sum())
        counts.append(mb.sum())
    part = tuple(Partial() if b == Shard(0) else Replicate() for b in batch)
    total = DTensor.from_local(torch.stack(losses).sum(), tm, part,
                               run_check=False)
    count = DTensor.from_local(torch.stack(counts).sum(), tm, part,
                               run_check=False)
    rep = (Replicate(),) * tm.ndim
    return (total.redistribute(tm, rep)
            / torch.clamp(count.redistribute(tm, rep), min=1.0))


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
        # zeros laid out as x (a DTensor's split included)
        state = torch.zeros_like(x[:, :1]).expand(-1, width - 1, -1)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    t = x.shape[1]
    y = sum(xp[:, i:i + t] * w[i] for i in range(width))
    new_state = xp[:, xp.shape[1] - (width - 1):]
    return y.to(x.dtype), new_state
