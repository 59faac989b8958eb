"""Round simulator: spray -> warm-up -> BitTorrent -> deadline (§III-A).

Orchestrates one FLTorrent round end to end and produces the metrics the
paper reports (T_warm, T_round, utilization, warm-up share) plus the
transfer log consumed by the attack suite (§IV-C) and the empirical
privacy-bound checks (§IV-A).

Two interchangeable *time engines* sit behind the same scheduling
contract (``time_engine=``):

* ``"slot"``  — the historical synchronous world: every stage costs one
  slot of ``cfg.slot_seconds``, capacities are integer chunks/slot, and
  the trace carries slot-boundary time stamps.
* ``"event"`` — the continuous-time transport of :mod:`repro_torch.net`:
  the SAME policies issue the SAME schedules (same rng stream, same
  integer budgets), but each directive cycle's transfers become max-min
  fair-share flows over raw bytes/s links (solved in float64 on
  ``device``, the GPU unless the caller names the CPU), every trace row
  gets real
  ``t_start``/``t_end`` instants, warm-up cycles pay tracker directive
  RTTs, and the metrics report realized wall-clock seconds
  (``t_warm_s``/``t_round_s``/``warmup_share_s``).

Fault model (§III-E): ``dropouts`` maps slot -> list of clients that
disconnect at that slot.  Dropped clients are excluded from all further
scheduling (tracker behaviour); chunks they uniquely held may leave some
updates unreconstructable, in which case aggregation proceeds over the
reconstructable active set — standard partial-participation semantics.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import numpy as np

from .. import obs, resolve_device
from ..net import EventEngine, NetConfig

from . import capacities as cap
from .bittorrent import bt_exact_slot, run_bt_fluid
from .byzantine import ByzantineModel, claimed_inventory, filter_transfers
from .maxflow import stage_upper_bound
from .overlay import random_overlay
from .policy import SlotView, get_policy
from .state import SwarmState
from .trace import TransferTrace
from .types import RoundMetrics, SwarmConfig


def _zero_clock() -> float:
    return 0.0


# Simulated time never reads the host clock (RNG007); the *measurement*
# clock behind RoundResult.timings is injected by the benchmarks via
# set_clock(time.perf_counter) and stays a constant zero otherwise.
_clock = _zero_clock


def set_clock(fn) -> None:
    """Install a wall-clock source for ``RoundResult.timings`` (pass
    ``None`` to restore the zero clock).  Benchmark-only: phase timings
    are diagnostics and never feed back into simulated time."""
    global _clock
    _clock = fn if fn is not None else _zero_clock


@contextlib.contextmanager
def measured_clock(fn=None):
    """Scoped measurement clock: install ``fn`` (default
    ``time.perf_counter``) as the phase-timing clock of BOTH this
    module and :mod:`repro_torch.core.jit_engine`, yield it, and ALWAYS
    restore the previous clocks on exit.

    This replaces the paired ``set_clock(...)`` / ``set_clock(None)``
    benchmark idiom, which leaked: an exception between the calls left
    the perf clock installed for subsequent determinism-sensitive code
    (timings are diagnostics, but a surviving host-clock hook is
    exactly what RNG007 exists to keep out of the sim layer).
    """
    from . import jit_engine

    if fn is None:
        fn = time.perf_counter
    prev, prev_jit = _clock, jit_engine._clock
    set_clock(fn)
    jit_engine.set_clock(fn)
    try:
        yield fn
    finally:
        set_clock(prev)
        jit_engine.set_clock(prev_jit)


@dataclass
class RoundResult:
    metrics: RoundMetrics
    log: TransferTrace             # typed transfer trace (dict-compatible)
    reconstructable: np.ndarray    # (n, n) bool: A_v^r membership
    active: np.ndarray             # (n,) bool at deadline
    adj: np.ndarray
    up: np.ndarray
    down: np.ndarray
    maxflow_ub: np.ndarray | None = None   # per warm-up slot
    warmup_sent_per_slot: np.ndarray | None = None
    fluid_bt: bool = False
    tracker_log: dict | None = None
    timings: dict | None = None    # wall seconds per run() phase (bench)
    # Async extensions (fl/asyncfl.py; all None/default on sync runs):
    cut: bool = False              # quorum cut fired before all_done
    tail: dict | None = None       # undelivered (snd, rcv, chunk) at cut
    late: dict | None = None       # drain-mode boundary deliveries
    drain_s: float = 0.0           # wall seconds of the boundary drain
    bg_delivered: dict | None = None   # prior-generation rows delivered
    bg_remaining: np.ndarray | None = None  # meta ids still queued


class RoundSimulator:
    """One FL round of FLTorrent dissemination."""

    def __init__(
        self,
        cfg: SwarmConfig,
        link_model: cap.LinkModel = cap.RESIDENTIAL,
        dropouts: dict[int, list[int]] | None = None,
        byzantine: ByzantineModel | None = None,
        bt_mode: str = "auto",          # "exact" | "fluid" | "auto"
        exact_limit: int = 4_000_000,   # n * total_chunks budget for exact
        *,
        overlay: np.ndarray | None = None,
        up: np.ndarray | None = None,
        down: np.ndarray | None = None,
        up_bps: np.ndarray | None = None,
        down_bps: np.ndarray | None = None,
        rng: np.random.Generator | None = None,
        spray_plan=None,
        time_engine: str = "slot",      # "slot" | "event"
        net=None,                       # net.NetConfig (event only)
        background=None,                # (snd, rcv, meta) carried tail
        device=None,                    # fair-share solves, jit engine
    ):
        """``overlay``/``up``/``down``/``rng`` let a :class:`SwarmSession`
        inject a persistent population (evolving topology, sticky
        capacities) instead of re-rolling everything from ``cfg.seed``.
        When omitted, construction is exactly the historical single-round
        path: seed the rng, sample a fresh overlay, sample capacities —
        in that order, so existing seeds reproduce bit-identically.

        ``time_engine="event"`` swaps the synchronous slot clock for the
        continuous-time transport of :mod:`repro_torch.net` (same
        schedules, wall-clock seconds, fair-share flow timing); ``net``
        is its :class:`~repro_torch.net.NetConfig` and ``device`` the
        torch device of its fair-share solves and of the jit slot
        engine (``cfg.scheduler_impl == "jit"``), resolved with
        :func:`repro_torch.resolve_device` only for those two (the GPU
        unless the caller names the CPU; no GPU and no device raises).
        ``up_bps``/``down_bps`` inject
        raw link rates alongside the integer budgets (sessions persist
        them); when omitted they are sampled from ``link_model`` via the
        same rng draws that produce the slot budgets, so both engines
        see the same physical links at the same seed.
        """
        if time_engine not in ("slot", "event"):
            raise ValueError(f"unknown time_engine {time_engine!r}")
        self.time_engine = time_engine
        self.device = (resolve_device(device)
                       if time_engine == "event"
                       or cfg.scheduler_impl == "jit" else None)
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed) if rng is None else rng
        self.adj = (random_overlay(cfg.n, cfg.min_degree,
                                   cfg.extra_edge_frac, self.rng)
                    if overlay is None else np.asarray(overlay, dtype=bool))
        if self.adj.shape != (cfg.n, cfg.n):
            raise ValueError(f"overlay shape {self.adj.shape} != "
                             f"({cfg.n}, {cfg.n})")
        if up is None or down is None:
            # One pair of uniform draws feeds BOTH time domains: raw
            # bytes/s for the event engine, quantized chunks/slot for
            # the slot engines (the historical draw order, so existing
            # seeds reproduce bit-identically).
            self.up_bps, self.down_bps = link_model.sample_rates(
                cfg.n, self.rng)
            self.up, self.down = cap.quantize_rates(
                self.up_bps, self.down_bps, cfg.chunk_bytes,
                cfg.slot_seconds, warn=(time_engine == "slot"))
        else:
            self.up = np.asarray(up, dtype=np.int64)
            self.down = np.asarray(down, dtype=np.int64)
            if up_bps is not None and down_bps is not None:
                self.up_bps = np.asarray(up_bps, np.float64)
                self.down_bps = np.asarray(down_bps, np.float64)
            else:
                # Budget-faithful fallback: rates that reproduce the
                # injected integer budgets exactly.
                self.up_bps = self.up * (cfg.chunk_bytes
                                         / cfg.slot_seconds)
                self.down_bps = self.down * (cfg.chunk_bytes
                                             / cfg.slot_seconds)
        if net is None and time_engine == "event":
            net = NetConfig()
        self.net = net
        self.dropouts = dropouts or {}
        if bt_mode == "auto":
            bt_mode = ("exact" if cfg.n * cfg.total_chunks <= exact_limit
                       else "fluid")
        self.bt_mode = bt_mode
        self.byz = byzantine
        self._fail_run = np.zeros(cfg.n, dtype=np.int64)
        self.state = SwarmState(cfg, self.adj, self.up, self.down, self.rng)
        # The jit slot engine's device, beside its other ``_jit_*``
        # caches on the state (core/jit_engine.py).
        self.state._jit_device = self.device
        # Warm-up scheduling policy: a registered name or a
        # SchedulerPolicy instance (core/policy.py).  Resolved once per
        # simulator; per-round mutable policy state is reset in run().
        self.policy = get_policy(cfg.scheduler)
        if not self.policy.applies_to("warmup"):
            raise ValueError(
                f"policy {self.policy.name!r} does not apply to the "
                f"warm-up phase (phases={self.policy.phases})")
        # Session-computed spray plan (churn-aware spray budgets); None
        # keeps the historical full re-spray path byte-identical.
        self.spray_plan = spray_plan
        # Carried background tail (async overlap): (snd, rcv, meta)
        # local-id arrays queued onto the event engine before the spray,
        # so the previous generation's tail contends with this round.
        if background is not None and time_engine != "event":
            raise ValueError("background tails need time_engine='event'")
        self.background = background

    # ------------------------------------------------------------------
    def _spray(self, engine=None):
        """Pre-round obfuscation (§III-B.1): sigma chunks per source to
        random non-neighbors over ephemeral tracker-coordinated tunnels.
        Happens before slot 0 and is not attributed to round pseudonyms
        (tunnels are torn down; attacks read phase==1 only).  Under the
        event engine the sprays are transported as fair-share flows and
        the tunnel brokering is charged to the control plane."""
        cfg = self.cfg
        st = self.state
        sigma = cfg.spray_copies
        if sigma == 0:
            return
        K = cfg.chunks_per_update
        if self.spray_plan is not None:
            # Session-provided plan (e.g. ChurnAwareSpray): explicit
            # (source, target, offset) triples, drawn from the session
            # stream — the simulator stream is left untouched.
            src, tgt, off = self.spray_plan.as_local_arrays()
            snd, tgts, chk = src, tgt, src * K + off
        else:
            # Vectorized over all sources at once: no per-client loop.
            nn = ~self.adj      # fresh array; safe to edit the diagonal
            np.fill_diagonal(nn, False)
            counts = nn.sum(axis=1)
            rows = np.flatnonzero(counts > 0)
            if rows.size == 0:
                return    # complete overlay: no non-neighbors
            m = min(sigma, K)
            # m distinct chunk offsets per source: top-m of a random
            # matrix (unordered-sample-without-replacement).
            keys = self.rng.random((rows.size, K))
            ids = (np.argpartition(keys, m - 1, axis=1)[:, :m] if m < K
                   else np.argsort(keys, axis=1))
            # One uniform non-neighbor per sprayed chunk (with
            # replacement): the pick-th non-neighbor in ascending
            # column order (the rank a stable argsort of ~nn yields).
            # Solved as an order-statistic fixed point over the row's
            # BLOCKED columns (neighbors + self, ~min_degree of them):
            # c = pick + |{blocked <= c}| converges from below in
            # O(deg) tiny iterations — no O(n^2 log n) sort and no
            # O(n^2) scan-sized temporaries, which dominated spray
            # setup at n=5000 (BENCH_scheduler.json before/after).
            pick = (self.rng.random((rows.size, m))
                    * counts[rows, None]).astype(np.int64)
            blk = self.adj[rows].copy()
            blk[np.arange(rows.size), rows] = True
            ri, ci = np.nonzero(blk)
            nblk = np.bincount(ri, minlength=rows.size)
            off = np.cumsum(nblk) - nblk
            maxb = int(nblk.max(initial=0))
            B = np.full((rows.size, maxb), cfg.n, dtype=np.int64)
            B[ri, np.arange(ri.size) - off[ri]] = ci
            tgts = pick.copy()
            for _ in range(maxb + 2):
                bumped = (pick
                          + (B[:, None, :] <= tgts[:, :, None]).sum(2))
                if np.array_equal(bumped, tgts):
                    break
                tgts = bumped
            tgts = tgts.ravel().astype(np.int64)
            snd = np.repeat(rows, m).astype(np.int64)
            chk = (rows[:, None] * K + ids).ravel()
        if engine is None:
            st.apply_transfers(snd, tgts, chk, phase_code=0,
                               consume_slot=False)
        else:
            ts, te = engine.spray(snd, tgts, chk)
            st.apply_transfers(snd, tgts, chk, phase_code=0,
                               consume_slot=False, t_start=ts, t_end=te)

    # ------------------------------------------------------------------
    def _schedule_filtered(self, scheduler_fn):
        """Run a slot scheduler against CLAIMED bitfields, then apply
        Byzantine behaviour + per-peer progress timeouts (SIII-E)."""
        st = self.state
        if self.byz is None:
            return scheduler_fn()
        real = st.have
        st.have = claimed_inventory(self.byz, st, self.rng)
        try:
            snd, rcv, chk = scheduler_fn()
        finally:
            st.have = real
        ok, fails = filter_transfers(self.byz, st, self.rng,
                                     snd, rcv, chk)
        served = np.zeros(self.cfg.n, dtype=bool)
        if len(snd):
            served[np.unique(np.asarray(snd)[ok])] = True
        self._fail_run = np.where(served, 0,
                                  self._fail_run + (fails > 0))
        timed_out = self._fail_run >= self.byz.timeout_slots
        if timed_out.any():
            st.active[timed_out] = False   # excluded from scheduling
        return (np.asarray(snd)[ok], np.asarray(rcv)[ok],
                np.asarray(chk)[ok])

    # ------------------------------------------------------------------
    def _apply_dropouts(self):
        for v in self.dropouts.get(self.state.slot, []):
            self.state.active[v] = False

    # ------------------------------------------------------------------
    def _quorum_met(self, k: int) -> bool:
        """FedBuff quorum (fl/asyncfl.py): >= k updates are swarm-
        complete — held in full by EVERY active peer, so a merge over
        them is identical at every peer (sole-writer consistency)."""
        st = self.state
        if not st.active.any():
            return True
        complete = st.reconstructable_sets()[st.active].all(axis=0)
        return int(complete.sum()) >= k

    def _extract_tail(self):
        """Undelivered (snd, rcv, chunk) work at the quorum cut.

        One row per missing (active receiver, chunk) pair; the sender is
        the active holder with the fastest uplink (ties break to the
        lowest id) — deterministic, zero rng draws, so the sync path's
        streams are untouched.  Chunks no active peer holds are
        unservable: their rows are dropped and the owning updates
        reported in ``dead_owners`` (they can never complete).

        ``ucols``/``holder_mask`` expose the cut-time holder sets of the
        missing chunks (local peer x unique chunk) — the carry path's
        relay replanner (session._map_backlog) re-picks senders from the
        *growing* holder set each round, so a scarce chunk spreads
        exponentially through background deliveries instead of fanning
        out of its sole original holder.
        """
        st = self.state
        K = self.cfg.chunks_per_update
        act = st.active
        rcv, chk = np.nonzero(act[:, None] & ~st.have)
        if rcv.size == 0:
            return None
        ucols, cinv = np.unique(chk, return_inverse=True)
        holder_mask = st.have[:, ucols] & act[:, None]
        score = np.where(holder_mask, self.up_bps[:, None], -1.0)
        best = np.argmax(score, axis=0)
        servable = score[best, np.arange(ucols.size)] > 0
        keep = servable[cinv]
        dead = np.unique(ucols[~servable] // K)
        if not keep.any():
            return {"snd": np.zeros(0, np.int64),
                    "rcv": np.zeros(0, np.int64),
                    "chunk": np.zeros(0, np.int64),
                    "dead_owners": dead,
                    "ucols": ucols[servable],
                    "holder_mask": holder_mask[:, servable]}
        return {"snd": best[cinv][keep].astype(np.int64),
                "rcv": rcv[keep].astype(np.int64),
                "chunk": chk[keep].astype(np.int64),
                "dead_owners": dead,
                "ucols": ucols[servable],
                "holder_mask": holder_mask[:, servable]}

    def _drain_tail(self, tail: dict, engine):
        """Deliver the whole tail at the round boundary (serialized
        wall clock — the no-overlap ablation).  Event engine: a solo
        fair-share drain.  Slot engine: a receiver-paced schedule on the
        slot grid (downlink budgets; an idealized lower bound — the
        event engine is the honest timing path).  Stamps are relative
        to the drain start."""
        cfg = self.cfg
        T = len(tail["snd"])
        if T == 0:
            return None, 0.0
        if engine is not None:
            engine.set_background(tail["snd"], tail["rcv"],
                                  np.arange(T, dtype=np.int64))
            t0 = engine.t
            meta, ts, te = engine.drain_background()
            ts_full = np.empty(T, np.float64)
            te_full = np.empty(T, np.float64)
            ts_full[meta] = ts
            te_full[meta] = te
            slot_idx = np.zeros(T, np.int64)
            drain_s = engine.t - t0
        else:
            rcv = tail["rcv"]          # receiver-major (nonzero order)
            first = np.searchsorted(rcv, rcv)
            posr = np.arange(T) - first
            slot_idx = posr // np.maximum(self.state.down[rcv], 1)
            ts_full = slot_idx * cfg.slot_seconds
            te_full = ts_full + cfg.slot_seconds
            drain_s = float((int(slot_idx.max()) + 1) * cfg.slot_seconds)
        late = {"snd": tail["snd"], "rcv": tail["rcv"],
                "chunk": tail["chunk"], "slot": slot_idx,
                "t_start": ts_full, "t_end": te_full}
        return late, float(drain_s)

    # ------------------------------------------------------------------
    def run(self, collect_maxflow: bool = False,
            warmup_only: bool = False,
            quorum_k: int | None = None,
            tail_mode: str = "none",
            bt_budget: int | None = None) -> RoundResult:
        cfg = self.cfg
        st = self.state
        if tail_mode not in ("none", "drain", "carry"):
            raise ValueError(f"unknown tail_mode {tail_mode!r}")
        if tail_mode == "carry" and self.time_engine != "event":
            raise ValueError("tail_mode='carry' needs time_engine="
                             "'event' (overlap is a flow-level notion)")
        if quorum_k is not None and (warmup_only
                                     or self.bt_mode == "fluid"):
            raise ValueError("quorum cuts need the exact BT engine")
        if bt_budget is not None and quorum_k is None:
            raise ValueError("bt_budget is an async deadline: it needs "
                             "quorum_k/tail_mode so the cut has a tail "
                             "path (otherwise it would silently mask)")
        engine = None
        rec = obs.get()
        _clk = _clock
        _t0 = _clk()
        if self.time_engine == "event":
            engine = EventEngine(cfg.n, cfg.chunk_bytes, self.up_bps,
                                 self.down_bps, self.net, cfg.seed,
                                 device=self.device)
            if self.background is not None:
                # Previous generation's tail: contends with this round's
                # spray/warm-up/BT from t=0 (overlapped dissemination).
                engine.set_background(*self.background)
        if cfg.enable_preround:
            self._spray(engine)
        t_spray_s = engine.t if engine is not None else 0.0
        _t_spray = _clk()

        ubs: list[int] = []
        # ---- warm-up (§III-B) ----
        pol = self.policy
        pol.reset(cfg)               # per-round policy state (flooding)
        view = SlotView(st, pol.visibility)
        idle = 0
        while not st.warmup_done() and st.slot < cfg.s_max:
            self._apply_dropouts()
            if collect_maxflow:
                ubs.append(stage_upper_bound(st))
            snd, rcv, chk = self._schedule_filtered(
                lambda: pol.schedule(view))
            if engine is None:
                st.apply_transfers(snd, rcv, chk, phase_code=1)
            else:
                ts, te = engine.warmup_cycle(st.slot, snd, rcv, chk)
                st.apply_transfers(snd, rcv, chk, phase_code=1,
                                   t_start=ts, t_end=te)
            if rec.enabled:
                rec.hist("sched.warmup_grants_per_slot", len(snd))
            st.slot += 1
            # Stall guard: lags leave early slots empty, and a receiver
            # whose only missing chunks are unreplicated owner chunks
            # may legally wait up to ~K/kappa slots for the owner's
            # throttled window to rotate around (state.owner_windows).
            # Only an idle run longer than both means no legal warm-up
            # transfer exists (e.g. sole suppliers dropped); fail open
            # to BT instead of spinning to s_max (liveness, §III-E).
            idle = idle + 1 if len(snd) == 0 else 0
            rotation = -(-cfg.chunks_per_update // max(cfg.owner_throttle, 1))
            if idle >= cfg.lag_slots + rotation + 8:
                break
        t_warm = st.slot
        _t_warmup = _clk()
        failed_open = not st.warmup_done()
        t_warm_s = (engine.t if engine is not None
                    else t_warm * cfg.slot_seconds)

        warm_sent_arr = np.asarray(st.per_slot_sent, dtype=np.int64)

        # ---- vanilla BitTorrent (§III-A step 4) ----
        st.phase = "bt"
        # warmup_only stops at the warm-up boundary (bench/scaling runs
        # where only the scheduled phase is under measurement); the
        # round result then reports the exact post-warm-up state.
        fluid = self.bt_mode == "fluid" and not warmup_only
        if warmup_only:
            pass
        elif fluid:
            eff_slots = run_bt_fluid(st, cfg.s_max - st.slot)
            if engine is not None:
                # Fluid BT is count-space; its realized duration is the
                # (fractional) capacity-bound slot count in seconds.
                engine.advance(eff_slots * cfg.slot_seconds)
        else:
            idle = 0
            bt_base = st.slot
            while not st.all_done() and st.slot < cfg.s_max:
                # FedBuff quorum (async): stop swarming the moment >= k
                # updates are swarm-complete; the rest become the tail.
                if quorum_k is not None and self._quorum_met(quorum_k):
                    break
                # Async round deadline: the directive-cycle budget after
                # warm-up.  Sync rounds idle-wait the stretched barrier
                # of every straggler cycle; the async cut bounds that
                # and hands the rest to the tail path.
                if bt_budget is not None and st.slot - bt_base >= bt_budget:
                    break
                self._apply_dropouts()
                snd, rcv, chk = self._schedule_filtered(
                    lambda: bt_exact_slot(st))
                if engine is None:
                    st.apply_transfers(snd, rcv, chk, phase_code=2)
                else:
                    ts, te = engine.bt_cycle(snd, rcv, chk)
                    st.apply_transfers(snd, rcv, chk, phase_code=2,
                                       t_start=ts, t_end=te)
                if rec.enabled:
                    rec.hist("sched.bt_grants_per_slot", len(snd))
                st.slot += 1
                idle = idle + 1 if len(snd) == 0 else 0
                if idle >= 3:
                    # No transfer possible for several slots (e.g. sole
                    # holders dropped): the round completes over the
                    # remaining reconstructable set (§III-E).
                    break
        t_round = st.slot
        _t_bt = _clk()
        t_round_s = (engine.t if engine is not None
                     else t_round * cfg.slot_seconds)

        # ---- async tail (quorum cut; fl/asyncfl.py) ----
        cut = quorum_k is not None and not st.all_done()
        tail = late = None
        drain_s = 0.0
        if cut and tail_mode != "none":
            tail = self._extract_tail()
            if tail is not None and tail_mode == "drain":
                late, drain_s = self._drain_tail(tail, engine)
        bg_delivered = bg_remaining = None
        if self.background is not None:
            bg_delivered = engine.background_log()
            bg_remaining = engine.background_remaining()

        # ---- metrics ----
        total_up = float(self.up.sum())
        m = RoundMetrics(
            t_warm=t_warm,
            t_round=t_round,
            t_warm_s=float(t_warm_s),
            t_round_s=float(t_round_s),
            t_spray_s=float(t_spray_s),
            control_s=(float(engine.tracker.control_s)
                       if engine is not None else 0.0),
            warmup_share_s=(float(t_warm_s / t_round_s)
                            if t_round_s else 0.0),
            warmup_chunks_sent=st.warmup_sent,
            bt_chunks_sent=st.bt_sent,
            warmup_utilization=(st.warmup_sent / (t_warm * total_up))
            if t_warm else 0.0,
            overall_utilization=((st.warmup_sent + st.bt_sent)
                                 / (t_round * total_up)) if t_round else 0.0,
            warmup_share=(t_warm / t_round) if t_round else 0.0,
            failed_open=failed_open,
            per_slot_warmup_util=(warm_sent_arr / total_up) if t_warm else None,
            active_at_deadline=st.active.copy(),
        )

        # ---- reconstructable sets (aggregation semantics §II-B) ----
        if fluid:
            # Fluid BT runs to completion: all updates reconstructable by
            # every active client (count-space equivalence).
            recon = np.tile(st.active[None, :], (cfg.n, 1))
            recon &= st.active[:, None]
        else:
            recon = st.reconstructable_sets()
            recon &= st.active[:, None]

        log = st.log.finalize(cfg.chunks_per_update, cfg.slot_seconds)
        _t_emit = _clk()
        # Per-phase instrumentation: one (name, sim start, sim end, host
        # wall) record per run() phase.  The obs spans are the
        # first-class stream; the legacy ``timings`` dict is derived
        # from the same checkpoints for back-compat consumers.
        phases = (("spray", 0.0, float(t_spray_s), _t_spray - _t0),
                  ("warmup", float(t_spray_s), float(t_warm_s),
                   _t_warmup - _t_spray),
                  ("bt", float(t_warm_s), float(t_round_s),
                   _t_bt - _t_warmup),
                  ("emit", float(t_round_s), float(t_round_s),
                   _t_emit - _t_bt))
        if rec.enabled:
            for name, s0, s1, wall in phases:
                rec.span_at(f"round.{name}", s0, s1, wall_s=wall)
            rec.span_at("round.total", 0.0, float(t_round_s),
                        wall_s=_t_emit - _t0, n=cfg.n,
                        engine=self.time_engine,
                        impl=cfg.scheduler_impl, cut=bool(cut),
                        failed_open=bool(failed_open))
            if drain_s:
                rec.span_at("round.drain", float(t_round_s),
                            float(t_round_s) + float(drain_s))
        return RoundResult(
            metrics=m, log=log, reconstructable=recon,
            active=st.active.copy(), adj=self.adj, up=self.up,
            down=self.down,
            maxflow_ub=np.asarray(ubs, dtype=np.int64) if collect_maxflow else None,
            warmup_sent_per_slot=warm_sent_arr,
            fluid_bt=fluid,
            tracker_log=(engine.control_log()
                         if engine is not None else None),
            timings={f"{name}_s": wall
                     for name, _, _, wall in phases},
            cut=cut, tail=tail, late=late, drain_s=drain_s,
            bg_delivered=bg_delivered, bg_remaining=bg_remaining,
        )


def simulate_round(cfg: SwarmConfig, collect_maxflow: bool = False,
                   warmup_only: bool = False, *, device=None,
                   **kw) -> RoundResult:
    return RoundSimulator(cfg, device=device, **kw).run(
        collect_maxflow=collect_maxflow, warmup_only=warmup_only)
