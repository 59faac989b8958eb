"""Vanilla BitTorrent swarming phase (paper §III-A step 4).

Two fidelity modes:

* **exact** — chunk-level rarest-first receiver-driven swarming using the
  same vectorized stage assignment as the warm-up schedulers, but with
  every held chunk eligible (no gating) and random holder selection
  (vanilla BitTorrent does not globally optimize sender choice).  Used
  for small/medium swarms and wherever per-chunk ground truth matters
  (dropout/reconstructable-set tests).

* **fluid** — capacity-bound transport approximation for large swarms
  (n x K beyond exact-sim budgets): per slot, receiver demand is spread
  over neighbors by remaining uplink with an availability cap
  ``|have_u \\ have_v| ~= got_u * (1 - got_v / C)`` (well-mixed chunk
  spread, accurate after warm-up).  Tracks only chunk *counts*; BT-phase
  chunk identities are never consumed by the privacy attacks (§IV-C
  observes warm-up transfers), so this loses no attack fidelity.

The paper's wall-clock results (Fig. 4, Table III, Fig. 8) are
capacity-dominated, which both modes reproduce.
"""
from __future__ import annotations

import numpy as np

from .policy import SlotView
from .state import SwarmState
from .schedulers import VanillaBTPolicy

_BT_POLICY = VanillaBTPolicy()          # stateless; shared singleton


def bt_exact_slot(state: SwarmState):
    """One slot of vanilla BT: rarest-first, random feasible senders.

    Drives the ``bt_vanilla`` policy (phase applicability ``("bt",)``)
    through the configured slot engine (``scheduler_impl``): with the
    default batched engine the whole-universe supply matrix is built
    once per slot and all receivers are matched in vectorized budgeted
    rounds, which is what makes chunk-level exact BT viable at paper
    scale (n x K in the millions).
    """
    return _BT_POLICY.schedule(SlotView(state, _BT_POLICY.visibility))


def run_bt_fluid(state: SwarmState, s_max: int) -> float:
    """Run the fluid BT phase to completion; returns *effective* slots.

    The return value is real-valued: the final iteration usually moves
    less than a full slot's worth of chunks, so it is credited
    fractionally (``sent_last / peak_sent``) — the event engine
    (:mod:`repro.net`) books ``effective_slots * slot_seconds`` of wall
    clock instead of rounding the tail up to a whole slot.  The integer
    state (``state.slot``, ``per_slot_sent``) keeps the historical
    whole-slot accounting.

    Mutates ``state.bt_sent`` and ``state.per_slot_sent`` only (count
    space).  ``state.have`` is left at its warm-up value; callers that
    complete the fluid phase should treat dissemination as complete for
    all active clients.
    """
    cfg = state.cfg
    C = float(cfg.total_chunks)
    active = state.active.copy()
    got = state.hold.astype(np.float64).copy()
    up = np.where(active, state.up, 0).astype(np.float64)
    down = np.where(active, state.down, 0).astype(np.float64)
    adj = state.adj

    slots = 0
    sent_hist: list[float] = []
    while slots < s_max:
        need = np.where(active, C - got, 0.0)
        if (need <= 1e-9).all():
            break
        demand = np.minimum(down, need)
        # Availability cap per (sender u -> receiver v):
        #   got_u * (1 - got_v / C), the expected |have_u \ have_v|
        # under well-mixed spread; elementwise outer product form.
        avail = got[:, None] * (1.0 - got[None, :] / C)    # (u, v)
        avail = np.where(adj, avail, 0.0)
        rem_up = up.copy()
        inflow = np.zeros_like(got)
        # Proportional water-filling, a few rounds.
        for _ in range(4):
            want = demand - inflow
            if (want <= 1e-9).all() or rem_up.sum() <= 1e-9:
                break
            # Receiver v asks each neighbor u proportionally to rem_up.
            weight = np.where(adj, rem_up[:, None], 0.0)
            wsum = weight.sum(axis=0)
            wsum = np.where(wsum > 0, wsum, 1.0)
            ask = weight * (want[None, :] / wsum)          # (u, v)
            # Clamp at zero: fp drift can push ``avail`` (and with a
            # tiny ``tot`` the rescale below) negative, which used to
            # explode ``inflow`` into huge negative "transfers" that
            # the integer slot accounting silently swallowed.
            ask = np.clip(ask, 0.0, np.maximum(avail, 0.0))
            # Senders scale down if oversubscribed.
            tot = ask.sum(axis=1)
            scale = np.where(tot > rem_up,
                             np.maximum(rem_up, 0.0)
                             / np.maximum(tot, 1e-12), 1.0)
            give = ask * scale[:, None]
            inflow += give.sum(axis=0)
            rem_up -= give.sum(axis=1)
            avail -= give
        got += inflow
        sent = float(inflow.sum())
        sent_hist.append(sent)
        state.per_slot_sent.append(int(round(sent)))
        state.bt_sent += int(round(sent))
        slots += 1
        state.slot += 1
        if sent <= 1e-9:
            break  # no progress possible (disconnected leftovers)
    # Mark logical completion for active clients.
    state.hold = np.where(active, np.maximum(state.hold, np.round(got).astype(np.int64)),
                          state.hold)
    eff = float(slots)
    if sent_hist:
        peak = max(sent_hist)
        if peak > 0:
            eff = slots - 1 + sent_hist[-1] / peak
    return eff
