"""Plain reference of one FedAvg round over P pods: each pod's gradient,
the torrent's aggregate, and one AdamW update, in f32.

The torrent: each pod's gradient leaves, in sorted-key order, make one
flat row of D values, cut into ``n_blocks`` blocks of ceil(D / n_blocks)
values (the last padded with zeros).  Compressed, each block goes over
the wire as int8 codes with one scale (``scale = amax / 127``, 1 for an
all-zero block; ``code = clip(round_half_even(x / scale), -127, 127)``)
and arrives as ``code * scale``.  The aggregate is the masked FedAvg
``sum_u m_u w_u x_u / sum_u m_u w_u``.

AdamW with global-norm clipping: ``g *= min(1, clip / |g|)``,
``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
``w -= lr (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd w)`` on
an f32 master copy; the model's weights are the master rounded to each
weight's stored dtype (bfloat16 where the configuration says so), and
the next round's forward and backward run in f32 from those.
"""
from __future__ import annotations

import math

import torch

from . import model

B1, B2, EPS, WEIGHT_DECAY, CLIP = 0.9, 0.95, 1e-8, 0.1, 1.0


def int8_roundtrip_(x: torch.Tensor) -> None:
    """Replace a block's f32 values by what its int8 codes stand for."""
    amax = x.abs().amax()
    scale = amax / torch.tensor(127.0) if float(amax) > 0 else \
        torch.tensor(1.0)
    x.copy_(torch.clamp(torch.round(x / scale), -127, 127) * scale)


def torrent_aggregate(rows, weights, active, *, n_blocks: int,
                      compress: bool) -> torch.Tensor:
    """rows (P, D) f32 (overwritten when compressed) -> (D,) the masked
    FedAvg of what arrives.  A block's zero padding changes no amax, so
    each block is the slice of the row it covers."""
    p, d = rows.shape
    db = -(-d // n_blocks)
    if compress:
        for u in range(p):
            for b in range(n_blocks):
                int8_roundtrip_(rows[u, b * db:min((b + 1) * db, d)])
    w = [float(a) * float(m) for a, m in zip(weights, active)]
    agg = torch.zeros(d, dtype=torch.float32, device=rows.device)
    if sum(w) <= 0:
        return agg
    for u, wu in enumerate(w):
        if wu > 0:
            agg.add_(rows[u], alpha=wu / sum(w))
    return agg


class AdamW:
    def __init__(self, params, lr: float):
        self.lr = lr
        self.t = 0
        self.w = [x.to(torch.float32, copy=True)          # the master
                  for x in model.leaves(params)]
        self.m = [torch.zeros_like(x) for x in self.w]
        self.v = [torch.zeros_like(x) for x in self.w]

    def update(self, grads):
        """Apply one step; returns the norm of each leaf of the clipped
        gradient."""
        self.t += 1
        g = model.leaves(grads)
        norm = math.sqrt(sum(float(x.double().pow(2).sum()) for x in g))
        s = min(1.0, CLIP / max(norm, 1e-12))
        bc1, bc2 = 1 - B1 ** self.t, 1 - B2 ** self.t
        norms = []
        for gi, w, m, v in zip(g, self.w, self.m, self.v):
            gi = gi * s
            m.mul_(B1).add_((1 - B1) * gi)
            v.mul_(B2).add_((1 - B2) * gi * gi)
            w.sub_(self.lr * ((m / bc1) / (torch.sqrt(v / bc2) + EPS)
                              + WEIGHT_DECAY * w))
            norms.append(float(gi.double().norm()))
        return norms


def run_rounds(cfg, params, batches, *, weights, active, n_blocks: int,
               compress: bool, lr: float, precision: str = "f32"):
    """Drive ``len(batches)`` rounds from ``params`` (leaves in their
    stored dtypes); ``batches[r]`` is ``(inputs, labels)``, each (P, B,
    T).

    Returns the readings the program's are compared with: the round's
    loss (the FedAvg-weighted mean of the pods' losses) for each round,
    the norm of each leaf of each pod's gradient in the first round, the
    norm of each leaf of the first round's clipped aggregate gradient,
    and the norm of each leaf's change over all the rounds.
    """
    w0, rebuild = model.flatten(params)
    opt = AdamW(params, lr)
    del params
    wn = torch.as_tensor(weights, dtype=torch.float64) \
        * torch.as_tensor(active, dtype=torch.float64)
    wn = wn / wn.sum()
    losses, first, pod_norms = [], None, None
    for inputs, labels in batches:
        weights_now = [w.to(x.dtype).float() for w, x in zip(opt.w, w0)]
        pods = []
        d = sum(w.numel() for w in opt.w)
        rows = torch.empty((inputs.shape[0], d), dtype=torch.float32,
                           device=opt.w[0].device)
        for u in range(inputs.shape[0]):
            loss, g = model.loss_and_grad(cfg, rebuild(weights_now),
                                          inputs[u], labels[u], precision)
            pods.append(loss)
            off = 0
            for x in model.leaves(g):
                rows[u, off:off + x.numel()] = x.reshape(-1)
                off += x.numel()
            del g
        del weights_now
        if pod_norms is None:
            pod_norms = [leaf_norms(r, opt.w) for r in rows]
        agg = torrent_aggregate(rows, weights, active, n_blocks=n_blocks,
                                compress=compress)
        del rows
        grads, off = [], 0
        for w in opt.w:
            grads.append(agg[off:off + w.numel()].reshape(w.shape))
            off += w.numel()
        norms = opt.update(rebuild(grads))
        del agg, grads
        first = norms if first is None else first
        losses.append(sum(float(a) * l for a, l in zip(wn, pods)
                          if a > 0))
    change = [float((w - a.float()).double().norm())
              for w, a in zip(opt.w, w0)]
    return {"loss": losses, "pod_grad_norm": pod_norms, "grad_norm": first,
            "change_norm": change}


def leaf_norms(row: torch.Tensor, like: list) -> list[float]:
    """Norm of each leaf's stretch of a flat row laid out as ``like``."""
    out, off = [], 0
    for w in like:
        out.append(float(row[off:off + w.numel()].double().norm()))
        off += w.numel()
    return out
