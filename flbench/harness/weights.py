"""Weights drawn from the seed, on the device, in the program's leaf
layout and dtypes; the same values for the program and the reference.

The layout (paths, shapes, dtypes) is what the program's
``models.init_params`` declares, read on the meta device.  The values
are the benchmark's own: each leaf is drawn in pieces of whole rows of
its first axis (at most ``PIECE`` values), each piece from a generator
seeded by (seed, leaf, piece), as f32 normals times the leaf's std,
then cast to the leaf's dtype.  So any piece can be drawn again alone,
which the program's parameter change is measured against.

The std: a per-layer vector (a norm's scale, used as ``1 + w``) 0.05;
the embedding ``d_model ** -0.5``; every other matrix ``fan_in **
-0.5``, the fan-in being its per-layer shape's second-to-last size.
Leaves under ``cycles`` are stacked over the layers (axis 0).
"""
from __future__ import annotations

import numpy as np
import torch

PIECE = 1 << 25


def _walk(node, path, visit):
    if isinstance(node, dict):
        return {k: _walk(node[k], path + (str(k),), visit)
                for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return [_walk(c, path + (str(i),), visit)
                for i, c in enumerate(node)]
    return visit("/".join(path), node)


def layout(cfg):
    """The program's parameter tree on the meta device, and the (path,
    shape, dtype) of each of its leaves in sorted-key order."""
    from repro_torch.models import init_params
    meta = init_params(cfg, torch.Generator(), device="meta")
    specs = []
    _walk(meta, (), lambda p, x: specs.append((p, tuple(x.shape), x.dtype)))
    return meta, specs


def _std(path: str, shape: tuple) -> float:
    per_layer = shape[1:] if path.startswith("cycles/") else shape
    if len(per_layer) == 1:
        return 0.05
    if path == "embed":
        return shape[-1] ** -0.5
    return per_layer[-2] ** -0.5


def _seed(seed: int, leaf: int, piece: int) -> int:
    a, b = np.random.SeedSequence([seed, 2, leaf, piece]).generate_state(2)
    return (int(a) | int(b) << 32) & ((1 << 63) - 1)


def _pieces(shape: tuple):
    """Row ranges of axis 0 of at most PIECE values each (one row at least)."""
    row = int(np.prod(shape[1:], dtype=np.int64)) if len(shape) > 1 else 1
    step = max(1, PIECE // max(row, 1))
    return [(r, min(r + step, shape[0])) for r in range(0, shape[0], step)]


def draw_piece(specs, seed: int, i: int, j: int, device,
               f32: bool = False) -> torch.Tensor:
    """Piece ``j`` of leaf ``i``, in the leaf's dtype (f32 when ``f32``,
    holding the same values)."""
    path, shape, dtype = specs[i]
    lo, hi = _pieces(shape)[j]
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed, i, j))
    x = torch.randn((hi - lo,) + shape[1:], generator=gen,
                    dtype=torch.float32, device=device)
    x = (x * _std(path, shape)).to(dtype)
    return x.float() if f32 else x


def make_leaves(specs, seed: int, device) -> list:
    out = []
    for i, (_, shape, dtype) in enumerate(specs):
        t = torch.empty(shape, dtype=dtype, device=device)
        for j, (lo, hi) in enumerate(_pieces(shape)):
            t[lo:hi] = draw_piece(specs, seed, i, j, device)
        out.append(t)
    return out


def tree(meta, leaves: list):
    """``meta``'s tree with its leaves replaced, in sorted-key order."""
    it = iter(leaves)
    return _walk(meta, (), lambda p, x: next(it))


def change_norms(specs, seed: int, now: list, device) -> list[float]:
    """Norm of each leaf of ``now`` (the leaves' order) less the drawn
    leaf, piece by piece, in f32."""
    out = []
    for i, (_, shape, _) in enumerate(specs):
        sq = 0.0
        for j, (lo, hi) in enumerate(_pieces(shape)):
            d = now[i][lo:hi].float() - draw_piece(specs, seed, i, j,
                                                   device, f32=True)
            sq += float(d.double().pow(2).sum())
        out.append(sq ** 0.5)
    return out
