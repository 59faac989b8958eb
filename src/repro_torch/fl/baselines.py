"""Learning baselines the paper compares against (§V-B).

* **CFL** — centralized federated learning: a server FedAvgs all client
  updates each round (pragmatic upper bound).
* **GossipDFL** — representative mix-and-forward decentralized learning:
  each round, every client averages parameters with its overlay
  neighbors through a Metropolis-Hastings mixing matrix (doubly
  stochastic), the standard gossip step of [Lian et al. 2017; Koloskova
  et al. 2019].  Under heterogeneity this *attenuates* global
  information (partial mixing), which is precisely the failure mode
  FLTorrent avoids by disseminating full updates.

Port of the JAX package's ``fl/baselines.py``.  The products are
``torch.einsum`` on the updates' device, as the reference's are
``jnp.einsum``.  :func:`fedavg_server` normalises its weights in
float64 and then rounds them to f32, as the reference does; the
FLTorrent path's ``core.aggregation.fedavg_pytree`` normalises in f32.
The two stay apart, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import tree_map

from .models_small import accuracy


def fedavg_server(updates: list, weights: np.ndarray):
    """CFL aggregation over all clients."""
    w = np.asarray(weights, np.float64)
    wn = torch.from_numpy((w / w.sum()).astype(np.float32))
    wn = wn.to(tree_leaves(updates[0])[0].device)

    def combine(*leaves):
        return torch.einsum("n,n...->...", wn, torch.stack(leaves))

    return tree_map(combine, *updates)


def metropolis_weights(adj: np.ndarray) -> np.ndarray:
    """Doubly-stochastic mixing matrix over the overlay."""
    n = adj.shape[0]
    deg = adj.sum(1)
    w = np.zeros((n, n), np.float64)
    for i in range(n):
        for j in np.flatnonzero(adj[i]):
            w[i, j] = 1.0 / (1 + max(deg[i], deg[j]))
        w[i, i] = 1.0 - w[i].sum()
    return w


def gossip_mix(client_params: list, w: np.ndarray):
    """One gossip round: x_i <- sum_j W_ij x_j (mix-and-forward).

    The mix acts on the *post-local-update* params (local step first,
    then gossip — Koloskova et al. 2019) with the Metropolis matrix.
    """
    wj = torch.from_numpy(np.asarray(w, np.float32))
    wj = wj.to(tree_leaves(client_params[0])[0].device)

    def combine(*leaves):
        stacked = torch.stack(leaves)              # (n, ...)
        return torch.einsum("ij,j...->i...", wj, stacked)

    mixed = tree_map(combine, *client_params)
    # Unstack back into per-client pytrees.
    n = w.shape[0]
    return [tree_map(lambda l: l[i], mixed) for i in range(n)]


def gossip_eval(apply_fn, client_params: list, x, y) -> float:
    """GossipDFL round accuracy: mean of the per-client accuracies.

    Each client only holds its own partially-mixed model, so that is
    what gets evaluated.  Evaluating the client-MEAN model instead is
    wrong for this baseline: the Metropolis matrix is doubly stochastic,
    so mean_i(sum_j W_ij x_j) == mean_j(x_j) — the metric is invariant
    to the mix and silently reports an exact *uniform FedAvg* that no
    gossip node possesses (§V-B).
    """
    return float(np.mean([accuracy(apply_fn, p, x, y)
                          for p in client_params]))
