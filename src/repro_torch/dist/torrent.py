"""Torrent collective: chunked dissemination + masked FedAvg, on one device.

Port of ``repro/dist/torrent.py``'s single-device path.  Every client
ships its full update to every other client as fixed-size blocks, then
each client aggregates over the active set it reconstructed:

    flatten:     the per-pod update pytrees become one (P, n_blocks, db)
                 f32 buffer, leaves concatenated in ``jax.tree_util``
                 order (sorted dict keys), so the blocks, and with them
                 the quantization scales, match the JAX package's;
    compress:    each block is quantized to int8 + one f32 scale at its
                 source and dequantized by the receivers (one rounding
                 per element, <2% relative error);
    aggregate:   masked FedAvg  sum_u m_u w_u x_u / sum_u m_u w_u  over
                 the (P, D) buffer — the ``kernels.fedavg`` hot path.

On one device the P pods share the card and the ring's terminal state
is the source blocks themselves (``ring_allgather_emulated`` checks
that), so ``torrent_fedavg`` aggregates the (optionally
quantize-roundtripped) blocks directly, as the JAX single-device path
does.  The multi-GPU ring over ``torch.distributed`` is a later slice.

The kernels dispatch on the device of their tensors: CUDA kernels for
CUDA tensors, the plain versions for CPU tensors.  Unlike the JAX code
the round trip writes the dequantized values back into the buffer it
quantized, so a full-width step holds one (P, D) f32 buffer, not two.

Zero active mass returns zeros, never NaN.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fedavg import fedavg_reduce
from repro_torch.kernels.quantize import chunk_dequantize, chunk_quantize
from repro_torch.kernels.ref import masked_normalized_weights
from repro_torch.tree import flatten, unflatten

# Normalized FedAvg weights; all-zero (not NaN) when no active mass.
masked_weights = masked_normalized_weights


def alloc_blocks(p: int, d: int, n_blocks: int, device) -> torch.Tensor:
    """(P, n_blocks, db) f32 buffer for P flat updates of D values; the
    tail padding past D is zeroed, the rest is left for the caller."""
    db = -(-d // n_blocks)
    buf = torch.empty((p, n_blocks * db), dtype=torch.float32,
                      device=device)
    buf[:, d:].zero_()
    return buf.view(p, n_blocks, db)


def _flatten_updates(updates, n_blocks: int):
    """Pytree of (P, ...) leaves -> ((P, n_blocks, db) f32, meta)."""
    leaves, treedef = flatten(updates)
    p = leaves[0].shape[0]
    for l in leaves:
        if l.shape[0] != p:
            raise ValueError("all update leaves need the same leading "
                             f"(client) axis; got {l.shape[0]} vs {p}")
    shapes = [tuple(l.shape[1:]) for l in leaves]
    dtypes = [l.dtype for l in leaves]
    d = sum(l[0].numel() for l in leaves)
    blocks = alloc_blocks(p, d, n_blocks, leaves[0].device)
    flat = blocks.view(p, -1)
    off = 0
    for l in leaves:
        size = l[0].numel()
        flat[:, off:off + size].copy_(l.reshape(p, size))
        off += size
    return blocks, (treedef, shapes, dtypes, d)


def _unflatten(vec: torch.Tensor, meta):
    treedef, shapes, dtypes, d = meta
    vec = vec.reshape(-1)[:d]
    out, off = [], 0
    for shp, dt in zip(shapes, dtypes):
        size = 1
        for s in shp:
            size *= s
        out.append(vec[off:off + size].reshape(shp).to(dt))
        off += size
    return unflatten(treedef, out)


def _aggregate(flat: torch.Tensor, weights, active) -> torch.Tensor:
    """On-device masked FedAvg over the gathered (P, D) buffer.

    Zero-weight rows are selected out (not multiplied), so a pod that
    was masked because it diverged (NaN update) cannot poison the
    aggregate.  CUDA kernel for a CUDA buffer, plain version on the CPU.
    """
    return fedavg_reduce(flat, weights, active)


def _roundtrip(blocks: torch.Tensor) -> None:
    """Quantize every block to int8 and dequantize it back, in place."""
    p, nb, db = blocks.shape
    rows = blocks.view(p * nb, db)
    q, s = chunk_quantize(rows)
    chunk_dequantize(q, s, out=rows)


def ring_allgather_emulated(blocks: torch.Tensor, *,
                            compress: bool = False) -> torch.Tensor:
    """Single-device emulation of the P-1 stage ring.

    blocks: (P, n_blocks, db).  Returns gathered[dest, src, block, e],
    the buffer each pod holds after the ring, so tests can assert that
    every destination reconstructs every source.
    """
    p, n_blocks, db = blocks.shape
    if compress:
        q, s = chunk_quantize(blocks.reshape(p * n_blocks, db).contiguous())
        buf_q = q.reshape(p, n_blocks, db)
        buf_s = s.reshape(p, n_blocks, 1)
    else:
        buf = blocks
    gathered = torch.zeros((p,) + tuple(blocks.shape), dtype=torch.float32,
                           device=blocks.device)
    dest = torch.arange(p, device=blocks.device)
    for stage in range(p):
        if compress:
            payload = chunk_dequantize(
                buf_q.reshape(p * n_blocks, db).contiguous(),
                buf_s.reshape(p * n_blocks, 1)).reshape(p, n_blocks, db)
        else:
            payload = buf
        gathered[dest, (dest - stage) % p] = payload.float()
        if stage < p - 1:
            # every pod forwards to pod+1 == roll by +1 on the pod axis
            if compress:
                buf_q = torch.roll(buf_q, 1, dims=0)
                buf_s = torch.roll(buf_s, 1, dims=0)
            else:
                buf = torch.roll(buf, 1, dims=0)
    return gathered


def take_pods(tree, keep):
    """Slice the leading (pod) axis of every leaf to the surviving pods.

    The elastic re-mesh companion (§III-E): the aggregate of a P'-ring
    over ``take_pods(updates, keep)`` equals the P-ring's with the
    departed pods masked, because masked FedAvg renormalizes over the
    same surviving mass.
    """
    leaves, treedef = flatten(tree)
    idx = torch.as_tensor(keep, dtype=torch.long)
    return unflatten(treedef, [l.index_select(0, idx.to(l.device))
                               for l in leaves])


def aggregate_blocks(blocks: torch.Tensor, meta, weights, active, *,
                     compress: bool = False):
    """Masked FedAvg of a filled (P, n_blocks, db) buffer -> pytree.

    The single-device ring: after it every destination holds exactly
    the (optionally quantize-roundtripped) source blocks, so they are
    aggregated directly.  ``compress`` overwrites ``blocks``.
    """
    if compress:
        _roundtrip(blocks)
    agg = _aggregate(blocks.view(blocks.shape[0], -1), weights, active)
    return _unflatten(agg, meta)


def torrent_fedavg(updates, weights, active, *, n_blocks: int = 4,
                   compress: bool = False):
    """Masked FedAvg of per-pod updates via the torrent collective.

    updates: pytree whose leaves have leading axis P (stacked per-pod
    updates); weights, active: (P,).  Returns the aggregate pytree with
    the leading axis removed and each leaf in its input dtype.
    """
    blocks, meta = _flatten_updates(updates, n_blocks)
    return aggregate_blocks(blocks, meta, weights, active,
                            compress=compress)


__all__ = ["alloc_blocks", "aggregate_blocks", "masked_weights",
           "ring_allgather_emulated", "take_pods", "torrent_fedavg"]
