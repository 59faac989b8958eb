"""Faults planted in the program under a run, to show that ``correct``
catches them: each patches a function the program looks up by module
global, for as long as the block lasts.  Benchmark code only; the
program's files stay as they are.

* ``state_unchanged``: the optimizer step returns params and state as
  they came.
* ``half_batch``: each pod's gradient is taken over the first half of
  its rows, the mean over those.
* ``no_exchange``: the torrent aggregates the first pod's row alone, as
  if no other pod's row had arrived.
* ``answer_altered``: the aggregate comes out of ``fedavg_reduce`` with
  its first quarter doubled, as a sum where a mean is due.
"""
from __future__ import annotations

import contextlib

from harness.tracing import patched

FL_STEP = "repro_torch.dist.fl_step"


def _state_unchanged(orig):
    def step(grads, opt, params, *, lr, **kw):
        return params, opt
    return step


def _half_batch(orig):
    def grad(loss_fn, params, inp, lab, *args, **kw):
        half = max(1, inp.shape[0] // 2)
        return orig(loss_fn, params, inp[:half], lab[:half], *args, **kw)
    return grad


def _no_exchange(orig):
    def aggregate(blocks, meta, weights, active, **kw):
        only = active.clone()
        only[1:] = 0
        return orig(blocks, meta, weights, only, **kw)
    return aggregate


def _answer_altered(orig):
    def reduce(updates, weights, active):
        out = orig(updates, weights, active)
        out[: out.numel() // 4].mul_(2)
        return out
    return reduce


FAULTS = {
    "state_unchanged": (FL_STEP, "adamw_update", _state_unchanged),
    "half_batch": (FL_STEP, "_microbatched_value_and_grad", _half_batch),
    "no_exchange": (FL_STEP, "aggregate_blocks", _no_exchange),
    "answer_altered": ("repro_torch.dist.torrent", "fedavg_reduce",
                       _answer_altered),
}


def planted(name: str):
    """The fault ``name`` planted for the block (``None``: none)."""
    if name is None:
        return contextlib.nullcontext()
    module, attr, make = FAULTS[name]
    return patched(module, attr, make)
