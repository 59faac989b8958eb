"""Carry parameters and optimizer state across the two packages.

``jax.random`` initialisation cannot be reproduced in torch, so a test
that compares the packages starts both from the same JAX-initialised
weights.  The JAX side hands its trees over as nested dicts and lists
of numpy arrays (``jax.tree_util.tree_map(np.asarray, tree)``); these
functions turn them into the port's tensors and back.  numpy has no
native bfloat16: an array whose dtype is named ``bfloat16`` (the
``ml_dtypes`` type JAX uses) is read through its raw 16-bit pattern, and
``to_numpy`` returns bfloat16 tensors as float32 arrays (exact).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim import OptState
from repro_torch.tree import tree_map


def tensor_from_numpy(a, device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree, device, dtype=None):
    """Nested dicts/lists of numpy arrays -> the same tree of tensors."""
    return tree_map(lambda a: tensor_from_numpy(a, device, dtype), tree)


def opt_from_numpy(opt, device) -> OptState:
    """A JAX ``OptState`` (or any ``(step, master, m, v)`` sequence) of
    numpy arrays -> the port's ``OptState``."""
    step, master, m, v = opt
    return OptState(step=tensor_from_numpy(step, device, torch.int32),
                    master=params_from_numpy(master, device),
                    m=params_from_numpy(m, device),
                    v=params_from_numpy(v, device))


def to_numpy(tree):
    """Tree of tensors -> tree of numpy arrays (bfloat16 -> float32)."""
    def one(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_map(one, tree)
