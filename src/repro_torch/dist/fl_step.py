"""Pod-masked FL training step on one device.

Port of ``repro/dist/fl_step.py``'s train step (§III):

    1. every pod computes the gradient of ITS batch shard (a loop over
       the pods where the JAX code vmaps), writing it straight into its
       row of one (P, D) f32 buffer in ``jax.tree_util`` leaf order;
    2. the rows are disseminated and aggregated by the torrent
       collective (``dist.torrent``: optional int8 round trip, then the
       masked FedAvg kernel);
    3. the aggregate drives ONE AdamW update.

Fault tolerance is a mask: a straggler pod (``active[p] == 0``) still
computes its gradient, but its row is selected out of the aggregate, so
its batch cannot influence the result.  A round with zero active mass
is a no-op: params, moments and the step counter stay untouched.

``n_pods == 1`` folds the pod axis into the batch and runs plain
data-parallel SGD, with no collective.

``ElasticFLStep`` is the cross-round elastic form (§III-E): each call
dispatches on the batch's pod count and builds the step for a new P
once.  On one device every pod shares the card, so a re-mesh is only a
new buffer layout; params and optimizer state carry over unchanged.

The step updates params and optimizer state in place (see
``optim.adamw``); at full width (qwen3-1.7b, P = 2) it holds params,
fp32 master/m/v, the (P, D) buffer, the int8 codes, the f32 aggregate
and one pod's gradients: about 52 GB before activations.
"""
from __future__ import annotations

import torch

from repro_torch.dist.torrent import (aggregate_blocks, alloc_blocks,
                                      masked_weights, require_no_mesh)
from repro_torch.models import decode_step, train_loss
from repro_torch.optim import adamw_update
from repro_torch.tree import flatten, unflatten


def _value_and_grad(loss_fn, leaves, treedef, inp, lab):
    req = [l.detach().requires_grad_(True) for l in leaves]
    loss = loss_fn(unflatten(treedef, req), inp, lab)
    # a leaf the loss never reads (an mLSTM layer's up_r, as in JAX)
    # gets a zero gradient, as jax.grad gives it
    grads = torch.autograd.grad(loss, req, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), grads


def _write_row(out: torch.Tensor, grads, *, accumulate: bool) -> None:
    """Copy (or add) gradient leaves into a flat f32 row, in leaf order."""
    off = 0
    for g in grads:
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
                                 microbatch: int, out=None):
    """d loss / d params, accumulated over microbatches when enabled.

    ``loss_fn(params, inputs, labels)``.  Returns ``(loss, grads)``.
    With ``out`` (a flat f32 row of D values) the gradient is written
    there in leaf order and ``grads`` is None.  Accumulated gradients
    are f32, as in the JAX code; an unsplit gradient keeps the params'
    dtype.
    """
    leaves, treedef = flatten(params)
    nmb = _n_microbatches(inp.shape[0], microbatch)
    if nmb == 0:
        loss, grads = _value_and_grad(loss_fn, leaves, treedef, inp, lab)
        if out is None:
            return loss, unflatten(treedef, list(grads))
        _write_row(out, grads, accumulate=False)
        return loss, None
    if out is None:
        acc = [torch.zeros(l.shape, dtype=torch.float32, device=l.device)
               for l in leaves]
    else:
        out.zero_()
    acc_l = torch.zeros((), dtype=torch.float32, device=inp.device)
    for i in range(nmb):
        sl = slice(i * microbatch, (i + 1) * microbatch)
        loss, grads = _value_and_grad(loss_fn, leaves, treedef, inp[sl],
                                      lab[sl])
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


def make_fl_train_step(cfg, mesh=None, *, lr_schedule, n_pods: int,
                       rules=None, torrent_blocks: int = 4,
                       compress: bool = False, microbatch: int = 0,
                       ce_chunk: int = 512):
    """Returns step(params, opt, batch, weights, active) ->
    (params, opt, {"loss", "lr"}).

    batch: {"inputs": (n_pods, B_local, T[, D]), "labels": (...)}, the
    leading axis is the pod (FL client) axis; weights/active are
    (n_pods,) FedAvg weights and the round's participation mask.

    ``mesh`` and ``rules`` are the JAX package's sharding arguments:
    ``mesh=None`` is the single-device path (``rules`` then has nothing
    to place); a mesh raises (:func:`require_no_mesh`).
    """
    require_no_mesh(mesh)
    def loss_fn(p, x, y):
        return train_loss(cfg, p, x, y, ce_chunk=ce_chunk)

    def step(params, opt, batch, weights, active):
        lr = lr_schedule(opt.step)
        inputs, labels = batch["inputs"], batch["labels"]
        if n_pods <= 1:
            inp = inputs.reshape((-1,) + tuple(inputs.shape[2:]))
            lab = labels.reshape((-1,) + tuple(labels.shape[2:]))
            loss, agg = _microbatched_value_and_grad(
                loss_fn, params, inp, lab, microbatch)
            params, opt = adamw_update(agg, opt, params, lr=lr)
            return params, opt, {"loss": loss, "lr": lr}

        leaves, treedef = flatten(params)
        dev = leaves[0].device
        weights = torch.as_tensor(weights, device=dev)
        active = torch.as_tensor(active, device=dev)
        p = inputs.shape[0]
        split = _n_microbatches(inputs.shape[1], microbatch) > 0
        meta = (treedef, [tuple(l.shape) for l in leaves],
                [torch.float32 if split else l.dtype for l in leaves],
                sum(l.numel() for l in leaves))
        d = meta[3]
        blocks = alloc_blocks(p, d, torrent_blocks, dev)
        rows = blocks.view(p, -1)
        losses = torch.stack([
            _microbatched_value_and_grad(loss_fn, params, inputs[i],
                                         labels[i], microbatch,
                                         out=rows[i, :d])[0]
            for i in range(p)])
        del rows
        agg = aggregate_blocks(blocks, meta, weights, active,
                               compress=compress)
        del blocks
        wn = masked_weights(weights, active)
        # select (don't multiply): a pod masked because it diverged
        # reports a NaN loss, and 0 * NaN == NaN
        loss = torch.sum(torch.where(wn > 0, losses.float(), 0.0) * wn)
        # A round with zero active mass is a protocol no-op: params,
        # moments and the step counter stay untouched (zero grads would
        # still apply weight decay and advance the LR schedule).  Same
        # zero-mass definition as the aggregator's.
        if bool((wn > 0).any()):
            params, opt = adamw_update(agg, opt, params, lr=lr)
        return params, opt, {"loss": loss, "lr": lr}

    return step


class ElasticFLStep:
    """Elastic-P FL step: the step is rebuilt per active pod count.

    ``mesh_factory(p)`` returns the mesh to train ``p`` active pods on,
    as in the JAX package; a factory that returns ``None`` gives the
    single-device path, and a mesh raises
    (:func:`require_no_mesh`).  Each call dispatches on the batch's
    leading (pod) axis, so the caller slices its batch to the surviving
    pods (e.g. with :func:`repro_torch.dist.torrent.take_pods`) and the
    step follows:

        step = ElasticFLStep(cfg, lr_schedule=sched,
                             mesh_factory=lambda p: None)
        params, opt, m = step(params, opt, batch4, w4, a4)   # P=4
        params, opt, m = step(params, opt, batch3, w3, a3)   # P=3
        params, opt, m = step(params, opt, batch4, w4, a4)   # cached

    Params and optimizer state carry across pod counts unchanged (the
    §III-E recovery contract: a drop shrinks the collective, never
    resets training).
    """

    def __init__(self, cfg, *, lr_schedule, mesh_factory, **step_kw):
        self.cfg = cfg
        self.lr_schedule = lr_schedule
        self.mesh_factory = mesh_factory
        self.step_kw = dict(step_kw)
        self._cache: dict[int, object] = {}

    def step_for(self, n_pods: int):
        """The step for ``n_pods`` active pods; built once per count."""
        if n_pods not in self._cache:
            self._cache[n_pods] = make_fl_train_step(
                self.cfg, self.mesh_factory(n_pods),
                lr_schedule=self.lr_schedule,
                n_pods=n_pods, **self.step_kw)
        return self._cache[n_pods]

    @property
    def pod_counts(self) -> list[int]:
        """Pod counts a step has been built for (re-mesh history)."""
        return sorted(self._cache)

    def __call__(self, params, opt, batch, weights, active):
        p = int(batch["inputs"].shape[0])
        return self.step_for(p)(params, opt, batch, weights, active)


def make_serve_step(cfg):
    """Returns serve(params, caches, tokens, pos) ->
    (next_tokens, logits, caches): one greedy decode step.  The caches
    are updated in place (``models.decode_step``)."""

    def serve(params, caches, tokens, pos):
        logits, caches = decode_step(cfg, params, caches, tokens, pos)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, logits, caches

    return serve
