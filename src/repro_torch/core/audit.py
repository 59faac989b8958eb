"""Commit-then-reveal tracker accountability (paper §III-D).

Before seeing per-round inputs, the tracker commits to a seed hash
``h^r = H(seed^r)``.  After the round it reveals the seed and a log of
the overlay + warm-up directives.  Clients recompute the overlay from
the seed and verify the *verifiable hard constraints*:

  (i)   the revealed seed matches the commitment,
  (ii)  the overlay equals the seed-derived overlay (adjacency),
  (iii) every warm-up directive respects adjacency,
  (iv)  per-stage capacity caps are not exceeded,
  (v)   no redundant deliveries (a (receiver, chunk) pair scheduled
        at most once) except logged retries.

On any violation clients fail open to vanilla BitTorrent and void that
round's unlinkability guarantee (§IV-A "conditionality").
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

import numpy as np

from .overlay import random_overlay
from .trace import TransferTrace


def _h(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


@dataclass
class TrackerCommitment:
    round_id: int
    commitment: str                     # H(seed)

    @staticmethod
    def commit(round_id: int, seed: int) -> "TrackerCommitment":
        return TrackerCommitment(round_id, _h(f"{round_id}:{seed}".encode()))


@dataclass
class RoundLog:
    """What an auditable tracker reveals post-round."""
    round_id: int
    seed: int
    n: int
    min_degree: int
    extra_edge_frac: float
    adjacency_digest: str
    directives: list = field(default_factory=list)  # (slot, snd, rcv, chunk)
    retries: set = field(default_factory=set)       # logged retry pairs

    def digest(self) -> str:
        body = json.dumps(
            [self.round_id, self.seed, self.n, self.adjacency_digest,
             len(self.directives)], sort_keys=True).encode()
        return _h(body)


def adjacency_digest(adj: np.ndarray) -> str:
    return _h(np.packbits(adj).tobytes())


@dataclass
class AuditResult:
    ok: bool
    violations: list

    @property
    def fail_open(self) -> bool:
        return not self.ok


def directives_from_trace(trace) -> list:
    """Warm-up rows of a :class:`TransferTrace` as revealable tracker
    directives ``(slot, sender, receiver, chunk)`` — what an auditable
    tracker logs for the commit-then-reveal check (§III-D)."""
    tr = TransferTrace.from_log(trace)
    view = tr.warmup()
    return list(zip(view.slot.tolist(), view.sender.tolist(),
                    view.receiver.tolist(), view.chunk.tolist()))


def verify_directives(
    adj: np.ndarray,
    directives,
    up_budget: np.ndarray,
    down_budget: np.ndarray,
    retries: set | None = None,
) -> list:
    """Checks (iii)-(v) on a directive batch, vectorized.

    ``directives`` is a list of ``(slot, snd, rcv, chunk)`` tuples (see
    :func:`directives_from_trace`) or a :class:`TransferTrace`.  Returns
    the violation messages (empty = clean); one representative message
    per violated check, anchored at its first offending directive.
    """
    retries = retries or set()
    if isinstance(directives, TransferTrace):
        directives = directives_from_trace(directives)
    if not directives:
        return []
    arr = np.asarray(directives, dtype=np.int64)
    slot, snd, rcv, chk = arr.T
    violations: list[str] = []

    # (iii) adjacency
    bad = ~adj[snd, rcv]
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        violations.append(
            f"non-adjacent directive {snd[i]}->{rcv[i]}@{slot[i]}")

    # (iv) per-stage capacity caps: grouped counts per (slot, client)
    n = len(up_budget)
    for who, budget, label in ((snd, up_budget, "uplink"),
                               (rcv, down_budget, "downlink")):
        code = slot * n + who
        uc, cnt = np.unique(code, return_counts=True)
        over = cnt > np.asarray(budget)[uc % n]
        if over.any():
            i = int(np.flatnonzero(over)[0])
            violations.append(
                f"{label} cap exceeded for {uc[i] % n}@{uc[i] // n}")

    # (v) no redundant (receiver, chunk) deliveries except logged retries
    code = rcv * (chk.max() + 1) + chk
    order = np.argsort(code, kind="stable")
    dup = np.zeros(len(code), dtype=bool)
    dup[order[1:]] = code[order][1:] == code[order][:-1]
    if dup.any():
        for i in np.flatnonzero(dup):
            pair = (int(rcv[i]), int(chk[i]))
            if pair not in retries:
                violations.append(f"redundant delivery {pair}")
                break
    return violations


def verify_round(
    commitment: TrackerCommitment,
    log: RoundLog,
    up_budget: np.ndarray,
    down_budget: np.ndarray,
) -> AuditResult:
    """Client-side verification of the revealed round log (§III-D)."""
    violations: list[str] = []

    # (i) seed opens the commitment
    if _h(f"{log.round_id}:{log.seed}".encode()) != commitment.commitment:
        violations.append("seed does not match commitment")

    # (ii) overlay is the seed-derived overlay
    rng = np.random.default_rng(log.seed)
    adj = random_overlay(log.n, log.min_degree, log.extra_edge_frac, rng)
    if adjacency_digest(adj) != log.adjacency_digest:
        violations.append("overlay does not match seed derivation")

    # (iii)-(v) directive checks, vectorized over the batch
    violations += verify_directives(adj, log.directives, up_budget,
                                    down_budget, log.retries)
    return AuditResult(ok=not violations, violations=violations)
