"""Pod-masked FL training step.

Port of ``repro/dist/fl_step.py``'s train step (§III):

    1. every pod computes the gradient of ITS batch shard, writing it
       straight into a flat f32 row in ``jax.tree_util`` leaf order;
       within a pod the batch is data-parallel over the mesh's ``data``
       axis (each rank takes its slice, an ``all_reduce`` averages);
    2. the rows are disseminated and aggregated by the torrent
       collective (``dist.torrent``): on a mesh with a ``pod`` axis each
       rank computes its own pod's row and the ring carries it to the
       others; without one, a loop over the pods fills one (P, D)
       buffer on this device (optional int8 round trip, then the masked
       FedAvg kernel);
    3. the aggregate drives ONE AdamW update, the same on every rank.

Fault tolerance is a mask: a straggler pod (``active[p] == 0``) still
computes its gradient and rides the ring, but its row is selected out
of the aggregate, so its batch cannot influence the result.  A round
with zero active mass is a no-op: params, moments and the step counter
stay untouched.

``n_pods == 1`` folds the pod axis into the batch and runs plain
data-parallel SGD, with no torrent collective.

``ElasticFLStep`` is the cross-round elastic form (§III-E): each call
dispatches on the batch's pod count and builds the mesh and the step
for a new P once.  Params and optimizer state stay on each rank's
device across a re-mesh (the JAX package re-places them on the new
mesh).

Parameters are placed or replicated as the caller gives them.
Replicated (plain tensors), a ``data`` axis splits each batch and an
``all_reduce`` averages the gradients, and the expert-parallel MoE
(``models.layers``) runs over the ``model`` axis when the mesh has no
pod axis.  Placed (DTensors of ``sharding.param_specs`` on the pod's
``data`` x ``model`` sub-mesh, ``sharding.distribute_tree``), the
pod's batch becomes a DTensor split over ``data`` and DTensor's
backward already reduces the gradients to the parameters' placements;
a rank's gradient row holds its local shards, which the ring carries
to the same shard of every other pod, as JAX's ``shard_map`` ring
carries a device's.  The optimizer state takes the same placements.

Under an enabled ``repro_torch.obs`` recorder the step records regions
(spans the profiler and the device see): ``fl.round`` around the step,
with the round's host syncs and allocator retries; ``fl.grad`` (attr
``pod``) around each pod's gradient row, and inside it ``fl.forward``,
``fl.backward`` and ``fl.row_write``; ``fl.torrent``; ``fl.adamw``;
``fl.mass_sync``.  ``fl.row_write`` and ``fl.mass_sync`` are host-timed,
the rest stream-timed.  Under the default null recorder each site is
one empty call.

The step updates params and optimizer state in place (see
``optim.adamw``); at full width on one device (qwen3-1.7b, P = 2) it
holds params, fp32 master/m/v, the (P, D) buffer, the int8 codes, the
f32 aggregate and one pod's gradients: about 52 GB before activations.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.dist.torrent import (GroupTransport, _unflatten,
                                      aggregate_blocks, alloc_blocks,
                                      masked_weights, ring_fedavg)
from repro_torch.launch.mesh import pod_axis_size
from repro_torch.models import decode_step, train_loss
from repro_torch.optim import adamw_update
from repro_torch.sharding.api import (DEFAULT_RULES, axis_rules, axis_sizes,
                                      is_dtensor)
from repro_torch.tree import flatten, unflatten


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor itself."""
    return t.to_local() if is_dtensor(t) else t


def _value_and_grad(loss_fn, leaves, treedef, inp, lab):
    rec = obs.get()
    req = [l.detach().requires_grad_(True) for l in leaves]
    with rec.region("fl.forward", device=True):
        loss = loss_fn(unflatten(treedef, req), inp, lab)
    # a leaf the loss never reads (an mLSTM layer's up_r, as in JAX)
    # gets a zero gradient, as jax.grad gives it
    with rec.region("fl.backward", device=True):
        grads = torch.autograd.grad(loss, req, allow_unused=True,
                                    materialize_grads=True)
    # a DTensor gradient may come back Partial (summed over the batch
    # split) or laid out otherwise: bring it to its parameter's layout
    grads = tuple(g.redistribute(l.device_mesh, l.placements)
                  if is_dtensor(g) and g.placements != l.placements else g
                  for g, l in zip(grads, leaves))
    if is_dtensor(loss):
        loss = loss.full_tensor()
    return loss.detach(), grads


def _write_row(out: torch.Tensor, grads, *, accumulate: bool) -> None:
    """Copy (or add) gradient leaves into a flat f32 row, in leaf order."""
    off = 0
    with obs.get().region("fl.row_write"):
        for g in grads:
            g = _local(g)
            n = g.numel()
            dst = out[off:off + n]
            if accumulate:
                dst.add_(g.reshape(-1))
            else:
                dst.copy_(g.reshape(-1))
            off += n


def _n_microbatches(b: int, microbatch: int) -> int:
    """Number of microbatches, or 0 when the batch is not split."""
    if microbatch <= 0 or b <= microbatch:
        return 0
    if b % microbatch:
        raise ValueError(f"local batch {b} is not divisible by "
                         f"microbatch {microbatch}; the split would "
                         "silently fall back to full-batch memory")
    return b // microbatch


def _microbatched_value_and_grad(loss_fn, params, inp, lab,
                                 microbatch: int, out=None, place=None):
    """d loss / d params, accumulated over microbatches when enabled.

    ``loss_fn(params, inputs, labels)``.  Returns ``(loss, grads)``.
    With ``out`` (a flat f32 row of D values) the gradient is written
    there in leaf order and ``grads`` is None.  Accumulated gradients
    are f32, as in the JAX code; an unsplit gradient keeps the params'
    dtype.  ``place(inp, lab)`` lays out each (micro)batch.
    """
    leaves, treedef = flatten(params)
    nmb = _n_microbatches(inp.shape[0], microbatch)
    place = place or (lambda x, y: (x, y))
    if nmb == 0:
        loss, grads = _value_and_grad(loss_fn, leaves, treedef,
                                      *place(inp, lab))
        if out is None:
            return loss, unflatten(treedef, list(grads))
        _write_row(out, grads, accumulate=False)
        return loss, None
    if out is None:
        acc = [torch.zeros_like(l, dtype=torch.float32) for l in leaves]
    else:
        out.zero_()
    acc_l = torch.zeros((), dtype=torch.float32, device=inp.device)
    for i in range(nmb):
        sl = slice(i * microbatch, (i + 1) * microbatch)
        loss, grads = _value_and_grad(loss_fn, leaves, treedef,
                                      *place(inp[sl], lab[sl]))
        acc_l = acc_l + loss
        if out is None:
            for a, g in zip(acc, grads):
                a.add_(g)
        else:
            _write_row(out, grads, accumulate=True)
    scale = 1.0 / nmb
    if out is None:
        return acc_l * scale, unflatten(treedef, [a.mul_(scale)
                                                  for a in acc])
    out.mul_(scale)
    return acc_l * scale, None


def _row_meta(params, b: int, microbatch: int):
    """``_unflatten``'s meta for a gradient row of ``params``: the
    aggregate takes the params' dtypes, or f32 where microbatches
    accumulate, as the JAX step's gradients do.  DTensor leaves give
    their local shards' shapes."""
    leaves, treedef = flatten(params)
    leaves = [_local(l) for l in leaves]
    split = _n_microbatches(b, microbatch) > 0
    return (treedef, [tuple(l.shape) for l in leaves],
            [torch.float32 if split else l.dtype for l in leaves],
            sum(l.numel() for l in leaves))


def _placed_like(agg, params):
    """The aggregate's local tensors as DTensors laid out as ``params``
    (plain leaves pass)."""
    from torch.distributed.tensor import DTensor
    out = [DTensor.from_local(a, p.device_mesh, p.placements,
                              run_check=False, shape=p.shape,
                              stride=p.stride()) if is_dtensor(p) else a
           for a, p in zip(flatten(agg)[0], flatten(params)[0])]
    return unflatten(flatten(params)[1], out)


def _placed_batch(params, inp, lab):
    """A pod's batch as DTensors on the parameters' mesh, split over
    ``data`` (this rank's slice already taken), or as given when the
    parameters are plain."""
    first = flatten(params)[0][0]
    if not is_dtensor(first):
        return inp, lab
    from torch.distributed.tensor import DTensor, Replicate, Shard
    tm = first.device_mesh
    pl = tuple(Shard(0) if n == "data" else Replicate()
               for n in tm.mesh_dim_names)
    return tuple(DTensor.from_local(t, tm, pl, run_check=False)
                 for t in (inp, lab))


def _any_mass(wn: torch.Tensor) -> bool:
    """Whether a round has active mass.  Under fake tensors (a dry run)
    the values are unknown and the update is traced, as a round with
    mass runs it."""
    from torch._subclasses.fake_tensor import is_fake
    with obs.get().region("fl.mass_sync"):
        return True if is_fake(wn) else bool((wn > 0).any())


def _data_shard(mesh, inp, lab):
    """This rank's slice of a batch along the mesh's ``data`` axis."""
    ds = 1 if mesh is None else int(axis_sizes(mesh).get("data", 1))
    if ds == 1:
        return inp, lab
    b = inp.shape[0]
    if b % ds:
        raise ValueError(f"batch {b} is not divisible by the data axis "
                         f"({ds} ranks)")
    sl = slice(mesh.coords["data"] * (b // ds),
               (mesh.coords["data"] + 1) * (b // ds))
    return inp[sl], lab[sl]


def _data_mean(mesh, *tensors) -> None:
    """Average tensors in place over the mesh's ``data`` group."""
    if mesh is None or "data" not in (mesh.groups or {}):
        return
    ds = mesh.shape["data"]
    for t in tensors:
        dist.all_reduce(t, group=mesh.groups["data"])
        t.div_(ds)


def make_fl_train_step(cfg, mesh=None, *, lr_schedule, n_pods: int,
                       rules=None, torrent_blocks: int = 4,
                       compress: bool = False, microbatch: int = 0,
                       ce_chunk: int = 512):
    """Returns step(params, opt, batch, weights, active) ->
    (params, opt, {"loss", "lr"}).

    batch: {"inputs": (n_pods, B_local, T[, D]), "labels": (...)}, the
    leading axis is the pod (FL client) axis, the same batch on every
    rank; weights/active are (n_pods,) FedAvg weights and the round's
    participation mask.

    ``mesh`` (a ``launch.mesh.DeviceMesh`` or None) and ``rules`` are
    the JAX package's sharding arguments.  With a ``pod`` axis of
    ``n_pods`` ranks each rank computes its own pod's gradient and the
    torrent ring aggregates; a ``data`` axis splits each batch over its
    ranks.  ``mesh=None`` is the single-device path.
    """
    rules = dict(DEFAULT_RULES if rules is None else rules)
    pod = pod_axis_size(mesh) if n_pods > 1 else 1
    if pod > 1 and pod != n_pods:
        raise ValueError(f"updates leading axis {n_pods} != pod axis size "
                         f"{pod}")

    def loss_fn(p, x, y):
        return train_loss(cfg, p, x, y, ce_chunk=ce_chunk)

    def grad_row(params, inp, lab, out, pod: int):
        """This rank's loss and gradient row for pod ``pod``'s batch."""
        with obs.get().region("fl.grad", device=True, pod=pod):
            inp, lab = _data_shard(mesh, inp, lab)
            placed = is_dtensor(flatten(params)[0][0])
            loss, _ = _microbatched_value_and_grad(
                loss_fn, params, inp, lab, microbatch, out=out,
                place=lambda x, y: _placed_batch(params, x, y))
            loss = loss.float().reshape(1)
            if not placed:
                # placed gradients are reduced by DTensor's backward
                _data_mean(mesh, out, loss)
            return loss[0]

    def step(params, opt, batch, weights, active):
        with (obs.get().region("fl.round", device=True, round=True),
              axis_rules(rules, mesh)):
            return _step(params, opt, batch, weights, active)

    def _step(params, opt, batch, weights, active):
        lr = lr_schedule(opt.step)
        inputs, labels = batch["inputs"], batch["labels"]
        if n_pods <= 1:
            inp = inputs.reshape((-1,) + tuple(inputs.shape[2:]))
            lab = labels.reshape((-1,) + tuple(labels.shape[2:]))
            if mesh is None:
                loss, agg = _microbatched_value_and_grad(
                    loss_fn, params, inp, lab, microbatch)
            else:
                meta = _row_meta(params, inp.shape[0], microbatch)
                row = torch.empty(meta[3], dtype=torch.float32,
                                  device=inp.device)
                loss = grad_row(params, inp, lab, row, 0)
                agg = _placed_like(_unflatten(row, meta), params)
            with obs.get().region("fl.adamw", device=True):
                params, opt = adamw_update(agg, opt, params, lr=lr)
            return params, opt, {"loss": loss, "lr": lr}

        dev = _local(flatten(params)[0][0]).device
        weights = torch.as_tensor(weights, device=dev)
        active = torch.as_tensor(active, device=dev)
        p = inputs.shape[0]
        meta = _row_meta(params, inputs.shape[1], microbatch)
        d = meta[3]
        if pod > 1:
            me = mesh.coords["pod"]
            blocks = alloc_blocks(1, d, torrent_blocks, dev)
            loss_me = grad_row(params, inputs[me], labels[me],
                               blocks.view(1, -1)[0, :d], me)
            with obs.get().region("fl.torrent", device=True):
                flat, = ring_fedavg(GroupTransport.for_mesh(mesh),
                                    [blocks[0]], weights, active,
                                    compress=compress)
            del blocks
            agg = _placed_like(_unflatten(flat, meta), params)
            del flat
            # every pod's loss, for the masked mean below
            losses = torch.zeros((p,), dtype=torch.float32, device=dev)
            losses[me] = loss_me
            dist.all_reduce(losses, group=mesh.groups["pod"])
        else:
            blocks = alloc_blocks(p, d, torrent_blocks, dev)
            rows = blocks.view(p, -1)
            losses = torch.stack([
                grad_row(params, inputs[i], labels[i], rows[i, :d], i)
                for i in range(p)])
            del rows
            with obs.get().region("fl.torrent", device=True):
                agg = aggregate_blocks(blocks, meta, weights, active,
                                       compress=compress)
            agg = _placed_like(agg, params)
            del blocks
        wn = masked_weights(weights, active)
        # select (don't multiply): a pod masked because it diverged
        # reports a NaN loss, and 0 * NaN == NaN
        loss = torch.sum(torch.where(wn > 0, losses.float(), 0.0) * wn)
        # A round with zero active mass is a protocol no-op: params,
        # moments and the step counter stay untouched (zero grads would
        # still apply weight decay and advance the LR schedule).  Same
        # zero-mass definition as the aggregator's.
        if _any_mass(wn):
            with obs.get().region("fl.adamw", device=True):
                params, opt = adamw_update(agg, opt, params, lr=lr)
        return params, opt, {"loss": loss, "lr": lr}

    return step


class ElasticFLStep:
    """Elastic-P FL step: re-mesh + ring rebuild across rounds.

    ``mesh_factory(p)`` returns the mesh to train ``p`` active pods on
    (``launch.mesh.make_pod_mesh``), or ``None`` for the single-device
    path; it is consulted once per distinct pod count, so it must be
    called on every rank in the same order (it creates process groups).
    Each call dispatches on the batch's leading (pod) axis, so the
    caller slices its batch to the surviving pods (e.g. with
    :func:`repro_torch.dist.torrent.take_pods`) and the step re-meshes
    itself:

        step = ElasticFLStep(cfg, lr_schedule=sched, mesh_factory=mf)
        params, opt, m = step(params, opt, batch4, w4, a4)   # P=4 ring
        params, opt, m = step(params, opt, batch3, w3, a3)   # P=3 ring
        params, opt, m = step(params, opt, batch4, w4, a4)   # cached

    A rank outside the mesh for P (``not mesh.is_member``) must not
    call the step; ``step_for(p)`` builds the mesh without running it.
    Params and optimizer state carry across re-meshes unchanged and stay
    on each rank's device (the §III-E recovery contract: a drop shrinks
    the collective, never resets training).
    """

    def __init__(self, cfg, *, lr_schedule, mesh_factory, **step_kw):
        self.cfg = cfg
        self.lr_schedule = lr_schedule
        self.mesh_factory = mesh_factory
        self.step_kw = dict(step_kw)
        self._cache: dict[int, tuple] = {}

    def step_for(self, n_pods: int):
        """(mesh, step) for ``n_pods`` active pods; built once per count."""
        if n_pods not in self._cache:
            mesh = self.mesh_factory(n_pods)
            self._cache[n_pods] = (mesh, make_fl_train_step(
                self.cfg, mesh, lr_schedule=self.lr_schedule,
                n_pods=n_pods, **self.step_kw))
        return self._cache[n_pods]

    @property
    def pod_counts(self) -> list[int]:
        """Pod counts a step has been built for (re-mesh history)."""
        return sorted(self._cache)

    def __call__(self, params, opt, batch, weights, active):
        p = int(batch["inputs"].shape[0])
        mesh, step = self.step_for(p)
        if mesh is not None and not mesh.is_member:
            raise ValueError(f"rank {mesh.rank} is outside the {p}-pod "
                             f"mesh {mesh}")
        return step(params, opt, batch, weights, active)


def make_serve_step(cfg):
    """Returns serve(params, caches, tokens, pos) ->
    (next_tokens, logits, caches): one greedy decode step.  The caches
    are updated in place (``models.decode_step``)."""

    def serve(params, caches, tokens, pos):
        logits, caches = decode_step(cfg, params, caches, tokens, pos)
        nxt = _argmax_vocab(logits).to(torch.int32)
        return nxt, logits, caches

    return serve


def _argmax_vocab(logits: torch.Tensor) -> torch.Tensor:
    """``argmax`` over the last (vocabulary) dim.  For DTensor logits
    split over ``model`` each rank takes its slice's max and index, and
    one all-gather of those picks the first maximum, as ``argmax``
    does, without gathering the logits."""
    if not is_dtensor(logits):
        return torch.argmax(logits, dim=-1)
    from torch.distributed.tensor import DTensor
    from repro_torch.sharding.api import model_size, placements_like
    tm = logits.device_mesh
    last = logits.ndim - 1
    batch = placements_like(logits, 0, None)
    if model_size(logits) == 1:
        out = torch.argmax(logits.redistribute(tm, batch).to_local(), -1)
        return DTensor.from_local(out, tm, batch, run_check=False)
    local = logits.redistribute(tm, placements_like(logits, 0, last))
    local = local.to_local()
    vals, idx = local.max(dim=-1)
    grp = tm.get_group("model")
    ms = model_size(logits)
    idx = idx + tm.get_local_rank("model") * local.shape[-1]
    both = torch.stack([vals.float(), idx.float()])
    # the ranks' (2, ...) pairs concatenated along dim 0, as every
    # backend takes an all-gather's output
    every = torch.empty((ms * 2,) + tuple(both.shape[1:]),
                        dtype=both.dtype, device=both.device)
    dist.all_gather_into_tensor(every, both, group=grp)
    every = every.view((ms,) + tuple(both.shape))
    best = torch.argmax(every[:, 0], dim=0)         # first max: lowest rank
    out = every[:, 1].gather(0, best[None])[0].long()
    return DTensor.from_local(out, tm, batch, run_check=False)
