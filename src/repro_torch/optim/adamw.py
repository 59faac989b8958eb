"""AdamW with fp32 master weights + global-norm clipping, by hand.

Port of ``repro/optim/adamw.py`` (not ``torch.optim.AdamW``): model
params live in the model dtype (bf16 at full width); the optimizer
keeps fp32 master weights and fp32 moments (m, v), with ``b2=0.95``,
global-norm clipping and bias correction as the JAX code writes them.

Unlike the JAX function, ``adamw_update`` works in place: it updates
``state.master``, ``state.m``, ``state.v`` and ``params`` and returns
them, so a full-width step holds no second copy of the 20 GB of
optimizer state.  Callers that need the old state clone it first.

DTensor parameters give ``master``, ``m`` and ``v`` their placements
(``launch.specs.opt_state_specs``); ``step`` is a plain 0-dim tensor,
which DTensor treats as replicated.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.tree import flatten, leaves, tree_map


class OptState(NamedTuple):
    step: torch.Tensor         # () int32
    master: dict               # fp32 copy of params
    m: dict
    v: dict


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def adamw_init(params) -> OptState:
    dev = leaves(params)[0].device

    def zeros(x):
        return torch.zeros_like(x, dtype=torch.float32)

    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        master=tree_map(lambda x: x.detach().to(torch.float32, copy=True),
                        params),
        m=tree_map(zeros, params), v=tree_map(zeros, params))


@torch.no_grad()
def adamw_update(grads, state: OptState, params, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """Returns (params, new_state), both updated in place.  ``lr`` is
    the schedule's value at ``state.step``, computed by the caller."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    stepf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, device=stepf.device), stepf)
    leaves_g, treedef = flatten(grads)
    for tree in (state.m, state.v, state.master, params):
        if flatten(tree)[1] != treedef:
            raise ValueError("grads, params and optimizer state differ "
                             "in structure")
    for g, m, v, w, pp in zip(leaves_g, leaves(state.m), leaves(state.v),
                              leaves(state.master), leaves(params)):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        mhat = m / bc1
        vhat = v / bc2
        w.sub_(lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * w))
        pp.copy_(w)
    return params, OptState(step=step, master=state.master, m=state.m,
                            v=state.v)
