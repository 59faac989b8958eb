"""Update chunking, torrent descriptors, and reassembly (paper §II-A/B).

The data plane: a client's model update (a pytree of tensors) is
serialized into a flat f32 view, padded, and split into fixed-size
chunks (BitTorrent pieces).  A *torrent descriptor* carries per-chunk
hashes so receivers can verify integrity and discard corrupted payloads
(BEP-0003).  Under homogeneous update sizes, descriptors reveal only
chunk hashes and piece counts — not the owner identity (§II-B).

Port of the JAX package's ``core/chunking.py``.  Pack and unpack work
on tensors on their own device (the on-device side of dissemination);
hashing is host-side over the float32 bytes of a host copy, so
``desc_id`` and ``chunk_hashes`` equal the JAX package's on the same
values.  Leaves are flattened in ``jax.tree_util`` order
(``repro_torch.tree``).  At full width a swarm's updates are packed
into one preallocated ``(n, K, C/4)`` buffer (:func:`alloc_chunks`,
``pack_chunks(..., out=buf[v])``), so no second copy of the stack is
ever alive.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.tree import flatten, unflatten


# ----------------------------------------------------------------------
# Flatten / unflatten pytrees <-> single fp32 vector
# ----------------------------------------------------------------------

def flatten_update(tree) -> tuple[torch.Tensor, tuple]:
    """Flatten a pytree of tensors into one fp32 vector + shape spec."""
    leaves, treedef = flatten(tree)
    spec = [(tuple(l.shape), l.dtype) for l in leaves]
    flat = torch.cat([l.reshape(-1).float() for l in leaves]) \
        if leaves else torch.zeros((0,), dtype=torch.float32)
    return flat, (treedef, spec)


def unflatten_update(flat: torch.Tensor, spec):
    treedef, shapes = spec
    leaves = []
    off = 0
    for shape, dtype in shapes:
        size = int(np.prod(shape)) if shape else 1
        leaves.append(flat[off:off + size].reshape(shape).to(dtype))
        off += size
    return unflatten(treedef, leaves)


# ----------------------------------------------------------------------
# Chunk pack / unpack (the device data plane)
# ----------------------------------------------------------------------

def chunk_count(num_bytes: int, chunk_bytes: int) -> int:
    """K_v^r = ceil(S_v^r / C)  (paper §II-B)."""
    return int(-(-num_bytes // chunk_bytes))


def alloc_chunks(n: int, num_elems: int, chunk_bytes: int,
                 device=None) -> torch.Tensor:
    """(n, K, C/4) f32 buffer for n updates of ``num_elems`` values each;
    the padding past ``num_elems`` is zeroed, the rest is left for the
    caller (``pack_chunks(flat, chunk_bytes, out=buf[v])``)."""
    elems_per_chunk = chunk_bytes // 4
    k = chunk_count(num_elems * 4, chunk_bytes)
    buf = torch.empty((n, k * elems_per_chunk), dtype=torch.float32,
                      device=device)
    buf[:, num_elems:].zero_()
    return buf.view(n, k, elems_per_chunk)


def pack_chunks(flat: torch.Tensor, chunk_bytes: int, *,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """(num_elems,) fp32 -> (K, C/4) fp32 chunk matrix with zero padding.

    With ``out`` (a contiguous (K, C/4) f32 tensor, e.g. one row of
    :func:`alloc_chunks`) the chunks are written there and ``out`` is
    returned; without it a new tensor is made on ``flat``'s device.
    """
    elems_per_chunk = chunk_bytes // 4
    n = flat.shape[0]
    k = chunk_count(n * 4, chunk_bytes)
    if out is None:
        out = torch.empty((k, elems_per_chunk), dtype=torch.float32,
                          device=flat.device)
    elif (tuple(out.shape) != (k, elems_per_chunk)
          or out.dtype != torch.float32 or not out.is_contiguous()):
        raise ValueError(f"pack_chunks: out must be a contiguous "
                         f"({k}, {elems_per_chunk}) float32 tensor, got "
                         f"{tuple(out.shape)} {out.dtype}")
    dst = out.view(-1)
    dst[:n].copy_(flat)
    dst[n:].zero_()
    return out


def unpack_chunks(chunks: torch.Tensor, num_elems: int) -> torch.Tensor:
    """(K, C/4) chunk matrix -> (num_elems,) fp32 vector."""
    return chunks.reshape(-1)[:num_elems]


# ----------------------------------------------------------------------
# Torrent descriptors (host-side integrity metadata)
# ----------------------------------------------------------------------

def _host_f32(x) -> np.ndarray:
    """A C-contiguous float32 host array of ``x`` (tensor or array)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).contiguous().numpy()
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


@dataclass(frozen=True)
class TorrentDescriptor:
    """Metadata published per update: chunk hashes + aggregation weight.

    ``desc_id`` is the public identity of the update in a round (attacks
    see desc ids, never owner indices).  ``weight`` is the FedAvg scalar
    (e.g. local sample count, §II-B).
    """

    desc_id: str
    num_chunks: int
    chunk_bytes: int
    total_bytes: int
    weight: float
    chunk_hashes: tuple = field(default_factory=tuple)

    @staticmethod
    def build(chunks, weight: float, salt: bytes = b"") -> "TorrentDescriptor":
        arr = _host_f32(chunks)
        hashes = tuple(
            hashlib.sha256(arr[i]).hexdigest() for i in range(arr.shape[0])
        )
        root = hashlib.sha256(("".join(hashes)).encode() + salt).hexdigest()[:16]
        return TorrentDescriptor(
            desc_id=root,
            num_chunks=arr.shape[0],
            chunk_bytes=arr.shape[1] * 4,
            total_bytes=arr.size * 4,
            weight=float(weight),
            chunk_hashes=hashes,
        )

    def verify_chunk(self, index: int, payload) -> bool:
        """Hash-check one received piece (Byzantine integrity, §III-E)."""
        h = hashlib.sha256(_host_f32(payload)).hexdigest()
        return h == self.chunk_hashes[index]


def make_update_torrent(tree, weight: float, chunk_bytes: int):
    """Convenience: pytree -> (chunks, descriptor, spec) for one client."""
    flat, spec = flatten_update(tree)
    chunks = pack_chunks(flat, chunk_bytes)
    desc = TorrentDescriptor.build(chunks, weight)
    return chunks, desc, (spec, flat.shape[0])


def reassemble_update(chunks: torch.Tensor, spec_and_len):
    spec, num_elems = spec_and_len
    return unflatten_update(unpack_chunks(chunks, num_elems), spec)
