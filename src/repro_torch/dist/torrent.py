"""Torrent collective: chunked ring dissemination + masked FedAvg.

Port of ``repro/dist/torrent.py``.  Every client ships its full update
to every other client as fixed-size blocks, then each client aggregates
over the active set it reconstructed.  On the ``pod`` axis of a mesh
that is a ring of P ranks (``ring_gather``, the reference's
``_ring_device_body``):

    source:      the rank's (n_blocks, db) f32 row; with ``compress``
                 quantized once to int8 codes + one f32 scale a block,
                 and the codes then circulate losslessly;
    stage s in 1..P-1:  every rank sends what it received last stage
                 (its own row at first) to rank (p+1) mod P, one P2P
                 send a block plus one for the scales, all in one
                 ``batch_isend_irecv``: (P-1) x n_blocks (+ P-1) sends
                 a rank, as the reference lowers (P-1) x n_blocks
                 ``collective-permute``s;
    each stage:  the payload lands in a (P, n_blocks, db) f32 buffer
                 at its SOURCE index (dequantized there when
                 compressed), so every rank's buffer, and with it the
                 masked FedAvg ``sum_u m_u w_u x_u / sum_u m_u w_u``
                 (``kernels.fedavg``), is the same bit for bit.

The ring body runs over a transport that moves a stage's blocks: a
``GroupTransport`` over a process group (NCCL for CUDA tensors, gloo
for CPU tensors; a tensor on the wrong kind of device raises), or a
``LocalTransport`` of P virtual ranks in one process, where a send is a
device copy (``ring_allgather_emulated``).  ``P2P`` counts the sends
and receives each pod rank issues.

Without a pod axis (``mesh=None``, or one pod) the pods share one
device and the ring's terminal state is the (optionally quantize-
roundtripped) source blocks themselves, so ``torrent_fedavg``
aggregates them directly, as the JAX single-device path does.  Unlike
the JAX code the round trip writes the dequantized values back into
the buffer it quantized, so a full-width step holds one (P, D) f32
buffer, not two.

The flattened blocks follow ``jax.tree_util`` leaf order (sorted dict
keys), so they, and with them the quantization scales, match the JAX
package's.  The kernels dispatch on the device of their tensors: CUDA
kernels for CUDA tensors, the plain versions for CPU tensors.  Zero
active mass returns zeros, never NaN.

Under an enabled ``repro_torch.obs`` recorder the int8 codes' kernels,
the masked FedAvg and the cast back to the leaves are host-timed
regions: ``torrent.quantize``, ``torrent.dequantize``,
``torrent.fedavg`` and ``torrent.unflatten``.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.kernels.fedavg import fedavg_reduce
from repro_torch.kernels.quantize import chunk_dequantize, chunk_quantize
from repro_torch.kernels.ref import masked_normalized_weights
from repro_torch.launch.mesh import pod_axis_size
from repro_torch.tree import flatten, unflatten

# Normalized FedAvg weights; all-zero (not NaN) when no active mass.
masked_weights = masked_normalized_weights

# ("send" | "recv", pod index) -> P2P operations that pod's rank issued
P2P: collections.Counter = collections.Counter()


def reset_p2p() -> None:
    P2P.clear()


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
    with obs.get().region("torrent.unflatten"):
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
    with obs.get().region("torrent.fedavg"):
        return fedavg_reduce(flat, weights, active)


def _roundtrip(blocks: torch.Tensor) -> None:
    """Quantize every block to int8 and dequantize it back, in place."""
    p, nb, db = blocks.shape
    rows = blocks.view(p * nb, db)
    rec = obs.get()
    with rec.region("torrent.quantize"):
        q, s = chunk_quantize(rows)
    with rec.region("torrent.dequantize"):
        chunk_dequantize(q, s, out=rows)


class LocalTransport:
    """P virtual pod ranks in one process: a send is a device copy."""

    def __init__(self, p: int):
        self.p = p
        self.ranks = list(range(p))

    def shift(self, sends, recvs) -> None:
        """``sends[i][j]`` of virtual rank i lands in ``recvs[i+1][j]``."""
        for i in self.ranks:
            src = sends[(i - 1) % self.p]
            for s, r in zip(src, recvs[i]):
                r.copy_(s)
            P2P["send", i] += len(sends[i])
            P2P["recv", i] += len(recvs[i])


class GroupTransport:
    """This rank of a pod ring over a process group: a stage sends to the
    next rank and receives from the previous one, one P2P operation a
    tensor, all in one ``batch_isend_irecv``."""

    def __init__(self, group, ranks: list[int], index: int):
        self.p = len(ranks)
        self.ranks = [index]
        self.group = group
        self._next = ranks[(index + 1) % self.p]
        self._prev = ranks[(index - 1) % self.p]
        # NCCL carries CUDA tensors, gloo CPU tensors: never a silent
        # staging copy through the host (a dry run's fake group takes
        # either)
        self._kind = {"nccl": "cuda", "gloo": "cpu"}.get(
            dist.get_backend(group))

    @classmethod
    def for_mesh(cls, mesh) -> GroupTransport:
        """The pod ring of this rank of ``mesh``."""
        if not mesh.is_member:
            raise ValueError(f"rank {mesh.rank} is not in {mesh}")
        return cls(mesh.groups["pod"], mesh.group_ranks["pod"],
                   mesh.coords["pod"])

    def shift(self, sends, recvs) -> None:
        (sends,), (recvs,) = sends, recvs
        ops = []
        for j, (s, r) in enumerate(zip(sends, recvs)):
            for t in (s, r):
                if self._kind and t.device.type != self._kind:
                    raise ValueError(
                        f"a {t.device} tensor cannot travel over a "
                        f"{dist.get_backend(self.group)} group: NCCL "
                        "carries CUDA tensors, gloo CPU tensors")
            ops.append(dist.P2POp(dist.isend, s, self._next, self.group,
                                  tag=j))
            ops.append(dist.P2POp(dist.irecv, r, self._prev, self.group,
                                  tag=j))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        P2P["send", self.ranks[0]] += len(sends)
        P2P["recv", self.ranks[0]] += len(recvs)


def ring_gather(transport, rows, *, compress: bool = False) -> list:
    """The ring's rank body for the pod ranks ``transport.ranks``.

    rows[i]: (n_blocks, db) update of pod ``transport.ranks[i]``.
    Returns each rank's (P, n_blocks, db) f32 buffer, row u holding pod
    u's update (dequantized from its source's codes when
    ``compress``).  Uncompressed, a rank forwards the buffer row it
    filled last stage and receives straight into the next one.
    """
    p = transport.p
    rec = obs.get()
    bufs, circ, spare = [], [], []
    for idx, my in zip(transport.ranks, rows):
        my = my.to(torch.float32).contiguous()
        buf = torch.empty((p,) + tuple(my.shape), dtype=torch.float32,
                          device=my.device)
        if compress:
            with rec.region("torrent.quantize"):
                q, s = chunk_quantize(my)       # once, at the source
            circ.append((q, s))
            spare.append((torch.empty_like(q), torch.empty_like(s)))
        else:
            buf[idx].copy_(my)
        bufs.append(buf)
    for stage in range(p):
        srcs = [(idx - stage) % p for idx in transport.ranks]
        if compress:
            for buf, src, (q, s) in zip(bufs, srcs, circ):
                with rec.region("torrent.dequantize"):
                    chunk_dequantize(q, s, out=buf[src])
        if stage == p - 1:
            break
        if compress:
            transport.shift([[*q.unbind(0), s] for q, s in circ],
                            [[*q.unbind(0), s] for q, s in spare])
            circ, spare = spare, circ
        else:
            transport.shift([list(b[src].unbind(0))
                             for b, src in zip(bufs, srcs)],
                            [list(b[(src - 1) % p].unbind(0))
                             for b, src in zip(bufs, srcs)])
    return bufs


def ring_fedavg(transport, rows, weights, active, *,
                compress: bool = False) -> list:
    """Masked FedAvg through the ring: each local rank's flat aggregate
    of its gathered buffer, every one bit-identical.  Each buffer is
    freed once its aggregate is taken."""
    bufs = ring_gather(transport, rows, compress=compress)
    out = []
    while bufs:
        buf = bufs.pop(0)
        out.append(_aggregate(buf.view(buf.shape[0], -1), weights, active))
    return out


def ring_allgather_emulated(blocks: torch.Tensor, *,
                            compress: bool = False) -> torch.Tensor:
    """The P-stage ring on one device, through ``LocalTransport``.

    blocks: (P, n_blocks, db).  Returns gathered[dest, src, block, e],
    the buffer each pod holds after the ring, so tests can assert that
    every destination reconstructs every source.
    """
    return torch.stack(ring_gather(LocalTransport(blocks.shape[0]),
                                   list(blocks), compress=compress))


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


def torrent_fedavg(updates, weights, active, *, mesh=None,
                   n_blocks: int = 4, compress: bool = False):
    """Masked FedAvg of per-pod updates via the torrent collective.

    updates: pytree whose leaves have leading axis P (stacked per-pod
    updates); weights, active: (P,).  Returns the aggregate pytree with
    the leading axis removed and each leaf in its input dtype.  On a
    mesh whose ``pod`` axis has P > 1 ranks each rank sends its own
    pod's row around the ring (``ring_fedavg``) and every rank returns
    the same aggregate; otherwise the pods share this device.
    """
    pod = pod_axis_size(mesh)
    p = flatten(updates)[0][0].shape[0]
    if pod > 1 and pod != p:
        raise ValueError(f"updates leading axis {p} != pod axis size {pod}")
    if pod > 1:
        transport = GroupTransport.for_mesh(mesh)
        blocks, meta = _flatten_updates(
            take_pods(updates, transport.ranks), n_blocks)
        agg, = ring_fedavg(transport, [blocks[0]], weights, active,
                           compress=compress)
        return _unflatten(agg, meta)
    blocks, meta = _flatten_updates(updates, n_blocks)
    return aggregate_blocks(blocks, meta, weights, active,
                            compress=compress)


__all__ = ["GroupTransport", "LocalTransport", "P2P", "alloc_blocks",
           "aggregate_blocks", "masked_weights", "reset_p2p",
           "ring_allgather_emulated", "ring_fedavg", "ring_gather",
           "take_pods", "torrent_fedavg"]
