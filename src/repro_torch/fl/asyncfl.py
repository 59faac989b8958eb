"""Deadline-free asynchronous FL: buffered staleness-weighted merges.

The paper's aggregation semantics are synchronous — FedAvg over the
updates reconstructable by a global round deadline, stragglers masked
out.  This runner removes the deadline FedBuff-style while keeping the
entire FLTorrent dissemination stack (spray, cover-set-gated warm-up,
BT swarming) underneath:

* every peer buffers updates as they become **swarm-complete** (held in
  full by every active peer — the P2P analogue of the server buffer),
  and merges once ``buffer_k`` of them are available (the quorum cut);
* stragglers are **down-weighted, not masked**: an update that misses
  the cut keeps disseminating and enters a later merge with weight
  ``w_u * (1 + s)^(-staleness_alpha)`` where ``s`` is its staleness in
  rounds (FedBuff/FedAsync-style polynomial decay);
* with ``overlap=True`` the undelivered tail becomes *background flows*
  on the next round's event engine
  (``repro_torch.net.EventEngine.set_background``): generation r's tail
  rides the same links as r+1's dissemination at STRICT lower
  priority, soaking only the residual capacity each foreground cycle
  leaves idle — the current generation's stamps are byte-identical
  with or without a carried tail, and partial chunk progress banks
  across cycle windows.  Each round boundary the session re-plans
  every tail row's sender to the least-finish-time active holder
  (``SwarmSession._map_backlog``) and orders the queue
  generation-first then owner-major, so whole updates complete at
  staleness 1 instead of every update trickling at staleness 2+.
  With ``overlap=False`` the tail drains serially at the round
  boundary (the ablation that isolates contention from buffering);
* ``max_staleness`` bounds the merge: updates older than the bound are
  dropped (masked), so ``max_staleness=0`` *is* the synchronous
  deadline — :func:`run_async_experiment` then reproduces
  ``run_experiment("fltorrent")`` seed-for-seed, byte-identical traces
  included.

Sole-writer merge consistency: the quorum requires completeness at
EVERY active peer and late tails deliver to every active peer, so all
peers assemble identical buffers and the "serverless" merge is the same
pytree everywhere — no coordination beyond the tracker the protocol
already has.  Peers that drop mid-round miss the merge and re-sync
through the stale-catch-up path, exactly like the sync runner.

Port of the JAX package's ``fl/asyncfl.py``.  The host side (the
session's quorum cut, tail settlement, pending and buffer bookkeeping,
the staleness weights in float64) is the reference's; the updates, the
merges and the evaluation are torch on ``device`` (the GPU unless the
caller names the CPU, as in :func:`repro_torch.fl.runner.run_experiment`),
and an event-engine session solves its fair shares on that device.
``params0`` starts the run from given numpy weights.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch import obs, resolve_device
from repro_torch.core import SwarmSession
from repro_torch.core.aggregation import fedavg_pytree
from repro_torch.core.chunking import chunk_count, flatten_update
from repro_torch.core.trace import TransferTrace
from repro_torch.tree import tree_map

from .client import apply_aggregate, compute_update
from .models_small import accuracy, true_f32
from .runner import FLConfig, _rows_agree, _Setup, make_session, setup_run


@dataclass(frozen=True)
class AsyncConfig:
    """Asynchrony knobs on top of :class:`~repro_torch.fl.runner.FLConfig`.

    ``buffer_k``         FedBuff buffer size K: merge once this many
                         updates are buffered (swarm-complete fresh ones
                         plus late tail completions; clamped to the
                         active count).
    ``max_staleness``    staleness bound S: an update still undelivered
                         s > S rounds after its generation is dropped.
                         0 = the synchronous deadline (exact parity
                         mode).
    ``overlap``          carry the tail as background flows into the
                         next round (event engine only) instead of
                         draining it at the boundary.
    ``round_slots``      async round deadline: BT directive-cycle budget
                         per round.  Sync rounds run the barriered cycle
                         loop to full completion — under straggler links
                         every cycle idle-waits the slowest flow; the
                         deadline cuts that and the relay-replanned tail
                         (core/session.py) delivers the rest without a
                         barrier.  None = cut on quorum/completion only.
    ``staleness_alpha``  polynomial staleness decay exponent.  Note the
                         merge normalizes weights, so the decay only
                         shifts RELATIVE mass inside a mixed-staleness
                         buffer — a uniformly-stale buffer is undamped
                         (that is what ``server_lr`` is for).
    ``server_lr``        FedBuff server learning rate: scales the merged
                         aggregate before it is applied.  Async deltas
                         are computed one merge behind the params they
                         land on, so a fast-moving model overshoots at
                         1.0; 0.5 geometrically damps the oscillation.
    ``time_engine``      "slot" | "event" — forwarded to the session.
    ``net``              event-engine NetConfig.
    ``link_model``       capacity model override (None = the session
                         default, RESIDENTIAL); pass
                         ``capacities.RESIDENTIAL_STRAGGLER`` for the
                         straggler-heavy frontier regime.
    ``evolve_overlay``   force the session's persistent-population mode
                         (sticky per-peer capacities across rounds).
                         Carry mode wants True: the relay replanner
                         routes tail rows via least-*finish-time*
                         holders, which needs stable rates to steer
                         around persistent stragglers.  None = session
                         default (parity mode must leave this unset).
    """

    buffer_k: int = 0
    max_staleness: int = 0
    overlap: bool = False
    round_slots: int | None = None
    staleness_alpha: float = 0.5
    server_lr: float = 1.0
    time_engine: str = "slot"
    net: object = None
    link_model: object = None
    evolve_overlay: bool | None = None

    def __post_init__(self):
        if self.overlap and self.max_staleness == 0:
            raise ValueError("overlap needs max_staleness >= 1 "
                             "(a tail to overlap)")
        if self.overlap and self.time_engine != "event":
            raise ValueError("overlap is a flow-level notion: needs "
                             "time_engine='event'")
        if self.max_staleness > 0 and self.buffer_k < 1:
            raise ValueError("async merges need buffer_k >= 1")
        if self.round_slots is not None and self.max_staleness == 0:
            raise ValueError("round_slots is a deadline WITHOUT masking: "
                             "it needs the async tail (max_staleness "
                             ">= 1) to recover the cut updates")
        if self.round_slots is not None and self.round_slots < 1:
            raise ValueError("round_slots must be >= 1")
        if not 0.0 < self.server_lr <= 1.0:
            raise ValueError("server_lr must be in (0, 1]")
        if self.server_lr != 1.0 and self.max_staleness == 0:
            raise ValueError("server_lr damps ASYNC merges; parity mode "
                             "applies the sync aggregate verbatim")


@dataclass
class AsyncResult:
    accuracy: list                 # per-round test accuracy
    wall_s: list                   # cumulative wall clock per round end
    merged: list                   # updates merged per round
    stale_merged: list             # of which late (staleness > 0)
    staleness_hist: dict           # staleness -> merge count
    dropped: int = 0               # updates lost (stale bound / dead)
    buffer_end: int = 0            # updates buffered, never merged
    agreement: bool = True
    reconstruct_frac: float = 1.0
    participation: list | None = None
    session: SwarmSession | None = None


def run_async_experiment(cfg: FLConfig, acfg: AsyncConfig, *,
                         device=None, params0=None) -> AsyncResult:
    """FedBuff-style asynchronous FLTorrent (sync-exact when
    ``acfg.max_staleness == 0``: same rng streams, same torch op order
    as :func:`~repro_torch.fl.runner.run_experiment`'s ``"fltorrent"``,
    byte-identical dissemination traces)."""
    dev = resolve_device(device)
    with true_f32():
        return _run_async(cfg, acfg, setup_run(cfg, dev, params0), dev)


def _run_async(cfg: FLConfig, acfg: AsyncConfig, st: _Setup, dev) -> AsyncResult:
    weights, apply_fn = st.weights, st.apply_fn
    params0, local_train, nprng = st.params0, st.local_train, st.nprng

    params = params0
    flat0, _ = flatten_update(params0)
    k_chunks = max(2, chunk_count(flat0.numel() * 4, 256 * 1024))
    session = make_session(
        cfg, k_chunks, dev,
        time_engine=acfg.time_engine, net=acfg.net,
        **({} if acfg.link_model is None
           else {"link_model": acfg.link_model}),
        **({} if acfg.evolve_overlay is None
           else {"evolve_overlay": acfg.evolve_overlay}))

    sync_mode = acfg.max_staleness == 0
    tail_mode = ("none" if sync_mode
                 else ("carry" if acfg.overlap else "drain"))

    client_params = [params0] * cfg.n_clients
    in_sync = np.ones(cfg.n_clients, dtype=bool)
    accs: list[float] = []
    agreement = True
    recon_fracs: list[float] = []
    participation: list[float] = []
    merged: list[int] = []
    stale_merged: list[int] = []
    hist: dict[int, int] = {}
    dropped = 0
    # (gen, owner_gid) -> (update pytree, raw weight): updates past the
    # cut, still disseminating.  Insertion-ordered, deterministic.
    pending: dict[tuple[int, int], tuple] = {}
    queued_ready: list = []        # drain mode: ready for NEXT merge
    # FedBuff buffer: (gen, update, weight) triples swarm-complete at
    # every peer, merged together once >= buffer_k are available.
    buffer: list[tuple] = []

    for r in range(cfg.rounds):
        ids = session.begin_round()
        # Rejoin-at-round-boundary: a returning client re-downloads the
        # CURRENT model before training (bookkeeping only in the sync
        # runner — dropping its staleness diagnostics perturbs no rng
        # stream, so parity holds).
        catchup = ids[~in_sync[ids]]
        for v in catchup:
            client_params[v] = params
            in_sync[v] = True
        participation.append(ids.size / cfg.n_clients)
        updates = []
        for v in ids:
            out = local_train(params, st.xs[v], st.ys[v], nprng)
            updates.append(compute_update(params, out))
        if sync_mode:
            rec = session.run_round()
        else:
            k_eff = min(max(acfg.buffer_k, 1), int(ids.size))
            rec = session.run_round(quorum_k=k_eff, tail_mode=tail_mode,
                                    bt_budget=acfg.round_slots)
        res = rec.result
        recon = res.reconstructable
        recon_fracs.append(float(recon.mean()))
        w_act = weights[ids]
        surv = np.flatnonzero(res.active)
        ref = int(surv[0]) if surv.size else 0

        if sync_mode:
            # The exact sync merge (fl/runner.py), same op order.
            if not bool((recon == recon[ref]).all()):
                agreement &= _rows_agree(updates, w_act, recon, surv, ref)
            agg = fedavg_pytree(updates, w_act, recon[ref])
            params = apply_aggregate(params, agg)
            merged.append(int(recon[ref].sum()))
            stale_merged.append(0)
        else:
            orec = obs.get()
            # Swarm-complete fresh updates (identical at every active
            # peer by the quorum definition — sole-writer merge) enter
            # the buffer at staleness 0; the rest go pending until the
            # tail delivers them everywhere.
            mask = (recon[res.active].all(axis=0) if res.active.any()
                    else np.zeros(ids.size, dtype=bool))
            for li in np.flatnonzero(~mask):
                pending[(r, int(ids[li]))] = (updates[li],
                                              float(w_act[li]))
            for key in rec.dead_updates:
                if pending.pop(key, None) is not None:
                    dropped += 1
                    orec.counter("async.dropped")
            if acfg.overlap:
                ready_keys = list(rec.late_ready)
            else:
                ready_keys = queued_ready
                queued_ready = list(rec.late_ready)
            for li in np.flatnonzero(mask):
                buffer.append((r, updates[li], float(w_act[li])))
            for key in ready_keys:
                ent = pending.pop(key, None)
                if ent is None:
                    continue
                if r - key[0] > acfg.max_staleness:
                    dropped += 1
                    orec.counter("async.dropped")
                    continue
                buffer.append((key[0], ent[0], ent[1]))
            # Entries that could only merge past the bound are masked.
            for key in list(pending):
                if r - key[0] >= acfg.max_staleness:
                    del pending[key]
                    dropped += 1
                    orec.counter("async.dropped")
            # FedBuff cut: merge the whole buffer once K are available,
            # each down-weighted by its staleness AT MERGE TIME.
            if len(buffer) >= k_eff:
                stale = [r - g for g, _, _ in buffer]
                all_w = np.asarray(
                    [w * (1.0 + s) ** (-acfg.staleness_alpha)
                     for (_, _, w), s in zip(buffer, stale)], np.float64)
                agg = fedavg_pytree([u for _, u, _ in buffer], all_w,
                                    np.ones(len(buffer), dtype=bool))
                if acfg.server_lr != 1.0:
                    agg = tree_map(lambda u: acfg.server_lr * u, agg)
                params = apply_aggregate(params, agg)
                merged.append(len(buffer))
                stale_merged.append(sum(1 for s in stale if s > 0))
                for s in stale:
                    if s > 0:
                        hist[s] = hist.get(s, 0) + 1
                if orec.enabled:
                    # Merge instant on the session wall clock: the end
                    # of round r including any boundary drain.
                    orec.event("async.merge",
                               t=res.metrics.t_round_s + res.drain_s,
                               merged=len(buffer),
                               stale_merged=stale_merged[-1],
                               pending=len(pending))
                    orec.counter("async.merges")
                    late = [s for s in stale if s > 0]
                    if late:
                        orec.hist("async.staleness", late)
                buffer = []
            else:
                merged.append(0)
                stale_merged.append(0)

        in_sync[:] = False
        got = ids[res.active]
        for v in got:
            client_params[v] = params
        in_sync[got] = True
        accs.append(accuracy(apply_fn, params, st.test_x, st.test_y))

    return AsyncResult(
        accuracy=accs, wall_s=list(np.asarray(session.offsets[1:])),
        merged=merged, stale_merged=stale_merged, staleness_hist=hist,
        dropped=dropped, buffer_end=len(buffer), agreement=agreement,
        reconstruct_frac=float(np.mean(recon_fracs)),
        participation=participation, session=session)


def adversary_view(session: SwarmSession) -> TransferTrace:
    """The wire-level view an async session exposes to observers.

    Late-tail traffic is protocol-indistinguishable from warm-up on the
    wire (chunks of some torrent arriving from a neighbor), so the
    conservative adversary model folds the late rows into the phase-1
    observation surface.  Their descriptors are band-shifted into a
    disjoint per-generation range: each stale generation's torrent keys
    its own descriptors, so the shift keeps the ground-truth
    (round, descriptor) -> owner grading injective while *enlarging* the
    descriptor cover set the attacker must disambiguate — the mechanism
    by which overlap changes unlinkability.
    """
    K = session.cfg.chunks_per_update
    base = [rec.global_log() for rec in session.history]
    lates = [rec.late_log for rec in session.history
             if rec.late_log is not None and len(rec.late_log)]
    if not lates:
        return TransferTrace.concat(base)
    band = int(session.n_peers) + 1
    shifted = []
    for la in lates:
        l2 = TransferTrace(K=la.K, **{k: getattr(la, k).copy()
                                      for k in la.keys()})
        l2.phase = np.full(len(l2), 1, dtype=np.int8)
        l2.chunk = (l2.chunk
                    + (l2.generation.astype(np.int64) + 1) * band * K)
        shifted.append(l2)
    return TransferTrace.concat(base + shifted)
