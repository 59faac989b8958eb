"""FL client: local SGD training producing a model update (paper §III-A.1).

Each round, client v computes ``g_v^r = params_local_after - params_in``
(the update that gets chunked and disseminated) with weight = local
sample count, matching FedAvg semantics.

Port of the JAX package's ``fl/client.py``.  The gradients come from
``torch.autograd`` on the parameter leaves; the momentum SGD update
(``m = momentum * m + g``, then ``p = p - lr * m``) and the numpy
batching (one ``rng.permutation`` an epoch, batches shorter than 2
skipped) are the reference's, so the same ``rng`` gives the same
batches.  A client's data goes to the parameters' device once a call
(the runners stage it there once a run), and each epoch's order once an
epoch; each batch is a gather on the device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.tree import flatten, tree_map, unflatten

from .models_small import cross_entropy


@dataclass
class LocalSpec:
    epochs: int = 5
    batch_size: int = 32
    lr: float = 0.05
    momentum: float = 0.9


def make_sgd_step(apply_fn, spec: LocalSpec):
    """One momentum SGD step on the flattened leaves of a parameter tree:
    (leaves, treedef, mom, xb, yb) -> (leaves, mom, grads)."""

    def sgd_step(leaves, treedef, mom, xb, yb):
        ps = [p.detach().requires_grad_() for p in leaves]
        loss = cross_entropy(apply_fn(unflatten(treedef, ps), xb), yb)
        grads = torch.autograd.grad(loss, ps)
        with torch.no_grad():
            mom = [spec.momentum * m + g for m, g in zip(mom, grads)]
            leaves = [p - spec.lr * m for p, m in zip(leaves, mom)]
        return leaves, mom, grads

    return sgd_step


def make_local_train(apply_fn, spec: LocalSpec):
    """Returns a (params, x, y, rng) -> new_params local trainer."""
    sgd_step = make_sgd_step(apply_fn, spec)

    def local_train(params, x, y, rng: np.random.Generator):
        leaves, treedef = flatten(params)
        dev = leaves[0].device
        x = torch.as_tensor(x, device=dev)
        y = torch.as_tensor(y, device=dev)
        mom = [torch.zeros_like(p) for p in leaves]
        n = len(y)
        for _ in range(spec.epochs):
            order = rng.permutation(n)
            idx = torch.from_numpy(order).to(dev)
            for i in range(0, n, spec.batch_size):
                if len(order[i:i + spec.batch_size]) < 2:
                    continue
                sl = idx[i:i + spec.batch_size]
                leaves, mom, _ = sgd_step(leaves, treedef, mom, x[sl],
                                          y[sl])
        return unflatten(treedef, leaves)

    return local_train


def compute_update(params_in, params_out):
    """g_v^r: the disseminated artifact (delta, FedAvg-compatible)."""
    return tree_map(lambda a, b: b - a, params_in, params_out)


def apply_aggregate(params_in, agg_update):
    return tree_map(lambda p, u: p + u, params_in, agg_update)
