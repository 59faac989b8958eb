"""FedAvg over the reconstructable active set (paper §II-B).

    g_v^agg,r = sum_{u in A_v^r} w_u / (sum_{j in A_v^r} w_j) * g_u^r

with A_v^r = {u : C_u^r subset of C_v^r[s_max]} and |A_v^r| >= 1.  When
every update is reconstructable by the deadline, all clients compute the
*identical* aggregate — the same value as server-based FedAvg — which is
the paper's core aggregation-semantics claim.

Port of the JAX package's ``core/aggregation.py``.  The computation is a
masked weighted reduction over stacked flat updates.
``fedavg_flat(use_kernel=True)`` goes to the ``fedavg_reduce`` kernel
(``repro_torch.kernels.ops.fedavg(impl="cuda")``): the CUDA kernel for
CUDA tensors, which reads only the rows of positive weight (the rows of
A_v), and its plain version for CPU tensors; a kernel that fails to
build or launch raises.  ``use_kernel=False`` keeps the JAX einsum's
semantics, where a masked NaN row poisons the result; the kernel path
selects such rows out.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import tree_map


def _f32(x, device=None) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return torch.as_tensor(x, device=device).float()


def fedavg_weights(weights, active) -> torch.Tensor:
    """Normalized FedAvg weights restricted to the active set."""
    w = _f32(weights) * _f32(active)
    total = torch.sum(w)
    return torch.where(total > 0, w / torch.clamp(total, min=1e-12), w)


def fedavg_flat(updates: torch.Tensor, weights, active,
                use_kernel: bool = False) -> torch.Tensor:
    """Masked weighted average of stacked flat updates (n, D) -> (D,)."""
    dev = updates.device
    if use_kernel:
        return kops.fedavg(updates, _f32(weights, dev), _f32(active, dev),
                           impl="cuda")
    wn = fedavg_weights(_f32(weights, dev), _f32(active, dev))
    return torch.einsum("n,nd->d", wn, updates.float())


def fedavg_pytree(updates: list, weights, active, use_kernel: bool = False):
    """FedAvg over a list of update pytrees (same treedef)."""
    wn = fedavg_weights(weights, active)

    def combine(*leaves):
        stacked = torch.stack([l.float() for l in leaves])
        return torch.einsum("n,n...->...", wn.to(stacked.device), stacked)

    return tree_map(combine, *updates)


def per_client_aggregates(updates: torch.Tensor, weights,
                          reconstructable) -> torch.Tensor:
    """Each client v aggregates over its own A_v^r: (n, D) -> (n, D).

    ``reconstructable[v, u]`` says update u is reconstructable at v by
    the deadline.  Rows with an empty active set return zeros (the
    protocol requires |A_v^r| >= 1; callers treat such clients as
    dropped for the round)."""
    dev = updates.device
    recon = _f32(reconstructable, dev)                        # (n, n)
    w = _f32(weights, dev)[None, :] * recon                   # (n, n)
    denom = torch.sum(w, dim=1, keepdim=True)
    wn = torch.where(denom > 0, w / torch.clamp(denom, min=1e-12),
                     torch.zeros((), device=dev))
    return wn @ updates.float()


def _flat_f32(leaves) -> torch.Tensor:
    if len(leaves) == 1:
        return leaves[0].reshape(-1).float()     # no copy of one f32 leaf
    return torch.cat([l.reshape(-1).float() for l in leaves])


def agreement_check(aggregates, atol: float = 1e-6) -> bool:
    """True when all per-client aggregates agree (full dissemination).

    Accepts a stacked (n, D) tensor or a list of same-treedef pytrees.
    Each aggregate is compared with the first in turn, so a list of
    full-width aggregates is never stacked into one more copy."""
    if isinstance(aggregates, (list, tuple)):
        flats = [_flat_f32(tree_leaves(a)) for a in aggregates]
    else:
        flats = list(aggregates)
    ref = flats[0]
    return all(bool(torch.max(torch.abs(a - ref)) <= atol)
               for a in flats)
