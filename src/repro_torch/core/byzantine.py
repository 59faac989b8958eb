"""Byzantine peer behaviours + operational handling (paper §II-C
Adversary B, §III-E).

The paper distinguishes (a) integrity-violating deviations — payload
tampering, detectable via the descriptor hash check, discarded on
receipt — and (b) liveness-degrading deviations — lying in bitfields,
withholding/delaying service.  Handling is operational: per-peer
progress timeouts mark non-serving peers inactive for *scheduling*;
warm-up completion is evaluated over the remaining active set; if
warm-up cannot finish by s_max the round fails open to vanilla BT.

Behaviours:

* ``"lie"``      — advertises chunks it does not hold; scheduled
                   transfers of those chunks deliver garbage that fails
                   the hash check and is discarded (wasted budget).
* ``"withhold"`` — accepts assignments but never transmits (silent
                   drop; pure timeout pressure).
* ``"slow"``     — serves at ~1/4 of its advertised uplink.

Unlinkability (§IV-A) is only claimed for transfers sent by HONEST
senders; tests/test_byzantine.py asserts Eq. (1) continues to hold on
exactly that set while the round stays live.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ByzantineModel:
    """behaviour per corrupted client + tracker timeout policy."""

    behaviours: dict = field(default_factory=dict)   # client -> behaviour
    timeout_slots: int = 5       # consecutive failed serves -> inactive
    lie_fraction: float = 0.5    # fraction of missing chunks advertised

    def __post_init__(self):
        for b in self.behaviours.values():
            assert b in ("lie", "withhold", "slow"), b

    def corrupt(self):
        return np.asarray(sorted(self.behaviours), dtype=np.int64)


def claimed_inventory(model: ByzantineModel, state, rng) -> np.ndarray:
    """Bitfields as reported to the tracker: liars over-claim."""
    claimed = state.have.copy()
    for u, b in model.behaviours.items():
        if b != "lie":
            continue
        missing = np.flatnonzero(~state.have[u])
        if missing.size == 0:
            continue
        k = int(len(missing) * model.lie_fraction)
        if k:
            fake = rng.choice(missing, size=k, replace=False)
            claimed[u, fake] = True
    return claimed


def filter_transfers(model: ByzantineModel, state, rng,
                     snd: np.ndarray, rcv: np.ndarray, chk: np.ndarray):
    """Apply behaviour to scheduled transfers.

    Returns (delivered mask, failed-serve counts per sender).  Lies
    surface as hash-check failures at the receiver (chunk discarded);
    withheld/slow transfers simply never arrive this slot.
    """
    n = state.cfg.n
    ok = np.ones(len(snd), dtype=bool)
    fails = np.zeros(n, dtype=np.int64)
    for i, (u, c) in enumerate(zip(snd, chk)):
        b = model.behaviours.get(int(u))
        if b is None:
            continue
        if b == "lie" and not state.have[int(u), int(c)]:
            ok[i] = False                      # garbage payload discarded
            fails[int(u)] += 1
        elif b == "withhold":
            ok[i] = False
            fails[int(u)] += 1
        elif b == "slow" and rng.random() > 0.25:
            ok[i] = False
            fails[int(u)] += 1
    return ok, fails
