"""Stage-wise max-flow upper bound on warm-up throughput (paper §III-C.1).

A bandwidth-optimal stage schedule maximizes the number of chunks moved
within a stage given current inventories and per-stage chunk budgets.
Following the paper, we do NOT run max-flow online — it is an *offline*
upper bound computed with full knowledge of the stage state (Fig. 1).

Network construction (tripartite relaxation):

    S --(u_cap[u])--> sender u --(supply(u,v))--> receiver v --(d_cap[v])--> T

where ``supply(u, v)`` counts distinct chunks u could deliver to v this
stage (eligible at u, missing at v, adjacency).  The relaxation drops
cross-sender chunk-distinctness at a receiver, so the value is a valid
upper bound on any integral chunk assignment; heuristic utilization
reported against it is therefore conservative (the paper's ≈92% claim is
measured the same way: heuristic throughput / max-flow UB).

The paper's Lemma 1 / Appendix A show *makespan-optimal* warm-up
scheduling is (strongly) NP-complete via P|prec|C_max and 3-Partition,
which is why the system ships heuristics; the bound here is the
throughput-side companion used in Fig. 3.

The time-domain companions (``stage_time_lower_bound``,
``warmup_time_bounds``) bound the event engine's cycles in seconds over
:func:`repro_torch.net.fairshare.congestion_bound`.  ``networkx`` is
imported where the count-space bound is computed, so a round that does
not collect it needs no networkx.
"""
from __future__ import annotations

import numpy as np

from .state import SwarmState


def stage_upper_bound(state: SwarmState) -> int:
    """Max chunks transferable in the current stage (offline UB)."""
    import networkx as nx

    cfg = state.cfg
    n = cfg.n
    sactive = state.senders_active()
    up = np.where(sactive, state.up, 0).astype(np.int64)
    down = np.where(state.active, state.down, 0).astype(np.int64)

    cand = state.candidate_columns(sactive)
    if cand.size == 0:
        return 0
    # Shared vectorized supply helper: one (n, m) eligibility build,
    # per-receiver rows are then plain slices (same path the batched
    # slot engine uses, so the UB sees exactly the engine's supply).
    sup_all = state.eligible_supply(cand)

    g = nx.DiGraph()
    for v in range(n):
        if down[v] <= 0 or not state.active[v]:
            continue
        nbr_idx = np.flatnonzero(state.adj[v] & (up > 0))
        if nbr_idx.size == 0:
            continue
        sup = sup_all[nbr_idx] & (~state.have[v, cand])[None, :]
        counts = sup.sum(axis=1)
        for j, u in enumerate(nbr_idx):
            if counts[j] > 0:
                g.add_edge(f"s{int(u)}", f"r{v}", capacity=int(counts[j]))
        if g.has_node(f"r{v}"):
            g.add_edge(f"r{v}", "T", capacity=int(down[v]))
    for u in range(n):
        if up[u] > 0 and g.has_node(f"s{u}"):
            g.add_edge("S", f"s{u}", capacity=int(up[u]))
    if not g.has_node("S") or not g.has_node("T"):
        return 0
    value, _ = nx.maximum_flow(g, "S", "T")
    return int(value)


# ----------------------------------------------------------------------
# Time-domain companion (repro.net): bandwidth-optimal seconds
# ----------------------------------------------------------------------

def stage_time_lower_bound(snd: np.ndarray, rcv: np.ndarray,
                           chunk_bytes: float,
                           up_bps: np.ndarray,
                           down_bps: np.ndarray) -> float:
    """Congestion lower bound (seconds) on transporting one cycle's
    scheduled transfers: no transport discipline can beat the busiest
    access link, ``max(bytes_out_u / up_u, bytes_in_v / down_v)``.

    The event engine's realized cycle makespan measured against this
    bound is the time-domain analogue of the paper's "~92% of the
    max-flow bound" claim: count-space max-flow bounds *what* could
    move per stage (:func:`stage_upper_bound`); this bounds *how fast*
    the chosen schedule could possibly move.
    """
    snd = np.asarray(snd, np.int64)
    rcv = np.asarray(rcv, np.int64)
    if snd.size == 0:
        return 0.0
    from ..net.fairshare import congestion_bound
    return congestion_bound(
        snd, rcv, np.full(snd.size, float(chunk_bytes)),
        np.asarray(up_bps, np.float64),
        np.asarray(down_bps, np.float64))


def warmup_time_bounds(trace, chunk_bytes: float, up_bps: np.ndarray,
                       down_bps: np.ndarray):
    """Per-cycle (lower-bound, realized) warm-up transport seconds.

    ``realized`` is measured from the trace's wall-clock stamps
    (``max t_end - min t_start`` per cycle — exact for zero-latency
    event runs, a tight proxy otherwise); ``lb`` from
    :func:`stage_time_lower_bound` on the same cycle's transfers.
    ``sum(lb) / sum(realized)`` is the time-domain bandwidth
    efficiency reported by ``benchmarks/fig3_utilization.py``.
    """
    warm = trace.phase_slice("warmup")
    # One grouped pass over the trace (sort by cycle, slice at cycle
    # boundaries) instead of a full-trace mask per cycle — this runs
    # per scheduler per seed at n=500 bench scale.
    order = np.argsort(warm.slot, kind="stable")
    slot_s = warm.slot[order]
    slots, starts = np.unique(slot_s, return_index=True)
    ends = np.r_[starts[1:], slot_s.size]
    snd_s, rcv_s = warm.sender[order], warm.receiver[order]
    ts_s, te_s = warm.t_start[order], warm.t_end[order]
    lbs = np.zeros(slots.size)
    real = np.zeros(slots.size)
    for i, (a, b) in enumerate(zip(starts, ends)):
        lbs[i] = stage_time_lower_bound(snd_s[a:b], rcv_s[a:b],
                                        chunk_bytes, up_bps, down_bps)
        real[i] = float(te_s[a:b].max() - ts_s[a:b].min())
    return lbs, real
