"""The numbers that decide ``correct``: the program's first rounds
against the reference's, on the same weights and batches.

Each reading is ``{"loss": [per round], "grad_norm": [per leaf],
"change_norm": [per leaf]}``: the round's FedAvg-weighted loss, the
norm of each leaf of the first round's gradient as the optimizer
takes it (after clipping), and the norm of each leaf's change over the
rounds.  A gap of norms is the gap between the two sides' norms of a
leaf over the larger of the reference's norm of that leaf and of the
median leaf, and the number compared is the worst leaf's.  A leaf whose
reference gradient is under ``NOUGHT`` of the median leaf's moves by
round-off alone and is left out of the change.
"""
from __future__ import annotations

import math
import statistics

NOUGHT = 1e-3


def _scaled(gaps: list, want: list, keep: list) -> list:
    """(gap, leaf) of each kept leaf: its gap over the larger of the
    reference's norm of the leaf and of the median leaf."""
    floor = statistics.median([w for w, k in zip(want, keep) if k])
    return [(g / max(w, floor, 1e-30), i)
            for i, (g, w) in enumerate(zip(gaps, want)) if keep[i]]


def _worst(gaps: list, want: list, keep: list) -> tuple[float, int]:
    out = _scaled(gaps, want, keep)
    bad = [(math.inf, i) for g, i in out if not math.isfinite(g)]
    return (bad or [max(out)])[0]


def _median(gaps: list, want: list, keep: list) -> tuple[float, int]:
    out = sorted(_scaled(gaps, want, keep))
    if any(not math.isfinite(g) for g, _ in out):
        return math.inf, -1
    return out[(len(out) - 1) // 2]


def gaps(prog: dict, ref: dict) -> dict:
    """The compared numbers, each with the leaf or round it came from."""
    loss = [abs(p - r) / abs(r) if math.isfinite(p) else math.inf
            for p, r in zip(prog["loss"], ref["loss"])]
    rg = ref["grad_norm"]
    med = statistics.median(rg)
    moves = [g >= NOUGHT * med for g in rg]
    every = [True] * len(rg)
    rc = ref["change_norm"]
    out = {"loss_gap": (max(loss), loss.index(max(loss))),
           "grad_norm_gap": _worst([abs(p - r) for p, r in zip(
               prog["grad_norm"], rg)], rg, every),
           "change_norm_gap": _worst([abs(p - r) for p, r in zip(
               prog["change_norm"], rc)], rc, moves),
           "change_median_gap": _median([abs(p - r) for p, r in zip(
               prog["change_norm"], rc)], rc, moves)}
    pods = [_worst([abs(p - r) for p, r in zip(pp, rr)], rr, every)
            for pp, rr in zip(prog["pod_grad_norm"], ref["pod_grad_norm"])]
    out["pod_grad_gap"] = max(pods)
    return out


def judge(found: dict, limits: dict) -> tuple[bool, dict]:
    """(every number the limits name within its limit, {name: {"value",
    "limit"}})."""
    out, ok = {}, True
    for name, lim in limits.items():
        if not isinstance(lim, (int, float)):
            continue
        v = found[name][0]
        out[name] = {"value": v, "limit": lim}
        ok = ok and math.isfinite(v) and v <= lim
    return ok, out
