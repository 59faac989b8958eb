"""Continuous-time event-driven transport engine (repro_torch.net).

``EventEngine`` is the second *time engine* behind
:class:`~repro_torch.core.simulator.RoundSimulator` (``time_engine="event"``).
The scheduling contract is untouched — the same
:class:`~repro_torch.core.policy.SchedulerPolicy` decides, per directive
cycle, exactly the transfers the slot engine would schedule (same rng
stream, same integer budgets) — but each cycle's transfers are then
*transported*: grouped into per-(sender, receiver) flows, rated by
max-min fair share over the raw bytes/s access links
(:mod:`repro_torch.net.fairshare`), pipelined chunk-by-chunk, and stamped
with real-valued ``t_start``/``t_end`` instants.  The wall clock
advances by each cycle's realized makespan plus the tracker directive
RTT (:mod:`repro_torch.net.tracker`), so round times come out in honest
seconds:

* a cycle that trickles (lags, closed gates) finishes early instead of
  costing a full slot;
* a cycle whose grants oversubscribe a receiver's downlink takes longer
  than a slot — queueing the slot world cannot express;
* warm-up pays coordination RTT per cycle, BT swarming does not.

In the homogeneous-capacity, zero-latency, zero-RTT limit the engine
reproduces the slot engine's per-cycle chunk transfer counts exactly
(it *is* the same schedule) and ``t_start`` ordering is consistent
with slot order (cycles are sequential barriers) — the cross-validation
anchor in ``tests/test_net.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import obs, resolve_device

from .fairshare import (congestion_bound, maxmin_rates, pipeline_starts,
                        transport)
from .tracker import TrackerControlPlane


def _bg_fluid(src, dst, flow_of, rem, up, down, window, quantum_frac,
              *, device=None):
    """Fluid transport of queued background entries over residual
    capacity, banking partial progress across cycle windows.

    Entries arrive grouped by flow (``flow_of[e]`` -> flow index into
    ``src``/``dst``, queue order within each flow) with ``rem[e]``
    bytes left.  Max-min rates are solved on the residual caps and the
    flows advance fluidly; an entry completes when its flow's delivered
    curve crosses its cumulative-byte threshold.  Unlike the foreground
    path, progress is BANKED: an entry cut off by ``window`` keeps its
    partial bytes for the next cycle — a background connection is
    long-lived, it does not restart because a directive cycle ended
    (chunk-whole retry here would livelock a wide backlog whose
    per-flow residual share moves less than one chunk per window).

    Returns per-entry ``(start, end)`` instants relative to the cycle
    start (``inf`` end = not finished inside ``window``), the updated
    per-entry remaining bytes, and the solve count.  The max-min solves
    run on ``device``.
    """
    nf = len(src)
    E = len(rem)
    frem = np.zeros(nf, np.float64)
    np.add.at(frem, flow_of, rem)
    cum = np.cumsum(rem)
    first_idx = np.searchsorted(flow_of, np.arange(nf))
    flow_base = (cum - rem)[first_idx]
    thr_end = cum - flow_base[flow_of]
    thr_start = thr_end - rem
    tol = 1e-6 * max(float(rem.max(initial=1.0)), 1.0)
    delivered = np.zeros(nf, np.float64)
    starts = np.full(E, np.inf, np.float64)
    ends = np.full(E, np.inf, np.float64)
    lb = congestion_bound(src, dst, frem, up, down)
    quantum = quantum_frac * lb
    alive = frem > tol
    t, nsol = 0.0, 0
    while alive.any() and t < window - 1e-12:
        idx = np.flatnonzero(alive)
        r = maxmin_rates(src[idx], dst[idx], up, down, device=device)
        nsol += 1
        dead = r <= 1e-9
        if dead.any():                # zero residual: no progress, bank
            alive[idx[dead]] = False
            idx, r = idx[~dead], r[~dead]
            if idx.size == 0:
                break
        ttf = frem[idx] / r
        dt = max(float(ttf.min()), quantum)
        if np.isfinite(window):
            dt = min(dt, window - t)
        rate_all = np.zeros(nf, np.float64)
        rate_all[idx] = r
        adv = np.minimum(rate_all * dt, frem)
        new_all = delivered + adv
        fo_new = new_all[flow_of]
        fo_rate = rate_all[flow_of]
        fo_old = delivered[flow_of]
        cs = np.isinf(starts) & (fo_new >= thr_start - tol) & (fo_rate > 0)
        starts[cs] = t + np.maximum(
            thr_start[cs] - fo_old[cs], 0.0) / fo_rate[cs]
        ce = np.isinf(ends) & (fo_new >= thr_end - tol) & (fo_rate > 0)
        ends[ce] = t + np.maximum(
            thr_end[ce] - fo_old[ce], 0.0) / fo_rate[ce]
        delivered = new_all
        frem = frem - adv
        alive = alive & (frem > tol)
        t += dt
    rem_after = np.where(
        np.isfinite(ends), 0.0,
        np.minimum(np.maximum(thr_end - delivered[flow_of], 0.0), rem))
    return starts, ends, rem_after, nsol


@dataclass(frozen=True)
class NetConfig:
    """Physical-layer knobs of the event engine.

    ``tracker_rtt_s``    warm-up directive network round-trip per cycle
                         (control plane, off the data path).
    ``tracker_solve_s``  per-cycle centralized assignment solve time:
                         the tracker collects availability and computes
                         the stage schedule before fanning directives
                         out — milliseconds at K~200 pieces, but a real
                         cost at LLM piece counts (10^4-10^5 pieces x
                         dozens of peers per cycle, §V-E).
    ``latency_lo_s``/``latency_hi_s``
                         per-peer one-way access propagation delay,
                         sampled uniformly once per round; a transfer
                         over (u, v) is delayed by ``lat[u] + lat[v]``.
    ``spray_setup_s``    one-off tunnel brokering before the spray.
    ``quantum_frac``     fair-share re-solve batching (see
                         :func:`repro_torch.net.fairshare.transport`).
    """

    tracker_rtt_s: float = 0.1
    tracker_solve_s: float = 0.0
    latency_lo_s: float = 0.0
    latency_hi_s: float = 0.0
    spray_setup_s: float = 0.0
    quantum_frac: float = 1 / 32

    def replace(self, **kw) -> "NetConfig":
        import dataclasses
        return dataclasses.replace(self, **kw)


# Paper-flavored presets.  Residential swarms (K ~ 200 pieces): tens of
# ms of access propagation, negligible assignment solves.  Datacenter
# LLM-scale swarms (§V-E): no propagation worth modeling, but each
# directive cycle's centralized assignment over 10^4-10^5 pieces costs
# real solve time — the dominant control-plane term behind the paper's
# ~6-10% FLTorrent-over-BT round-time overhead.
RESIDENTIAL_NET = NetConfig(tracker_rtt_s=0.1, latency_lo_s=0.005,
                            latency_hi_s=0.030)
DATACENTER_NET = NetConfig(tracker_rtt_s=0.1, tracker_solve_s=0.6)


class EventEngine:
    """Wall-clock transport of one round's scheduled transfer cycles.

    The engine owns its own rng stream (derived from ``seed`` with a
    fixed salt) so sampling propagation latencies never perturbs the
    simulator's scheduling stream — schedules stay bit-identical to the
    slot engine's at the same seed.  Every fair-share solve runs in
    float64 on ``device`` (:func:`repro_torch.resolve_device`: the GPU
    unless the caller names the CPU).
    """

    def __init__(self, n: int, chunk_bytes: int,
                 up_bps: np.ndarray, down_bps: np.ndarray,
                 net: NetConfig, seed: int, *, device=None):
        self.n = int(n)
        self.device = resolve_device(device)
        self.chunk_bytes = float(chunk_bytes)
        self.up_bps = np.asarray(up_bps, np.float64)
        self.down_bps = np.asarray(down_bps, np.float64)
        # A zero-rate link can never deliver, but the scheduling layer
        # would still mark its chunks delivered — so a scheduled flow
        # over one would stamp t_end = inf into the trace.  Reject it
        # up front (the slot world's >=1 chunk/slot clamp means only
        # direct rate injection can produce this).
        if (self.up_bps <= 0).any() or (self.down_bps <= 0).any():
            raise ValueError(
                "event engine needs strictly positive link rates; got "
                f"{int((self.up_bps <= 0).sum())} non-positive uplinks "
                f"and {int((self.down_bps <= 0).sum())} downlinks")
        self.net = net
        rng = np.random.default_rng(
            np.random.SeedSequence([int(seed) & 0x7FFFFFFF, 0x7E71]))
        if net.latency_hi_s > 0:
            self.lat = rng.uniform(net.latency_lo_s, net.latency_hi_s,
                                   size=self.n)
        else:
            self.lat = np.zeros(self.n, np.float64)
        self.t = 0.0                      # wall clock (seconds)
        self.tracker = TrackerControlPlane(
            rtt_s=net.tracker_rtt_s, solve_s=net.tracker_solve_s,
            spray_setup_s=net.spray_setup_s)
        self.n_solves = 0
        self.data_s = 0.0                 # time with data in flight
        # Background queue (async overlap, fl/asyncfl.py): one chunk per
        # entry, carried from a previous generation's tail.  Entries run
        # at strict lower priority over the residual capacity each
        # foreground cycle leaves idle (see _transport).
        self._bg_src = np.zeros(0, np.int64)
        self._bg_dst = np.zeros(0, np.int64)
        self._bg_meta = np.zeros(0, np.int64)
        self._bg_rem = np.zeros(0, np.float64)   # banked bytes remaining
        self._bg_log: list[dict] = []     # delivered-background batches

    # ------------------------------------------------------------------
    @staticmethod
    def _stamp_grid(tm, counts):
        """Full per-chunk (flow, end) grid for a transport result.

        Guards against fp under-emission: pads each flow's missing tail
        chunks with its finish instant so every transfer gets a stamp
        (dead zero-rate flows keep ``inf`` and are filtered by the
        delivery predicate downstream)."""
        emitted = np.bincount(tm.chunk_flow, minlength=len(counts))
        if (emitted < counts).any():
            miss = counts - emitted
            padf = np.repeat(np.flatnonzero(miss > 0), miss[miss > 0])
            cflow = np.concatenate([tm.chunk_flow, padf])
            cend = np.concatenate([tm.chunk_end, tm.finish[padf]])
            o = np.lexsort((cend, cflow))
            return cflow[o], cend[o]
        return tm.chunk_flow, tm.chunk_end

    def _transport(self, snd, rcv, t0: float, deliver_all_bg: bool = False,
                   track: str = "fg"):
        """Fair-share transport of one cycle's transfers from ``t0``.

        Returns aligned (t_start, t_end) arrays and the barrier instant
        (last foreground delivery).  Transfers between the same pair are
        pipelined in emission order — the policy emits rarest-first, so
        the wire order *is* the priority order.

        Queued background chunks (:meth:`set_background`) run at strict
        LOWER priority in a two-phase solve.  Phase 1 rates the
        foreground alone, so its stamps and barrier are byte-identical
        to a cycle with no carried tail — an old generation can never
        dilate the current one.  Phase 2 water-fills the background over
        each link's *residual* capacity — the bandwidth the foreground's
        max-min allocation left idle over the cycle window (fast peers
        blocked on a straggler's barrier are exactly the idle capacity
        async aggregation recovers).  Background chunks completed inside
        the window are logged and dequeued; the rest keep their partial
        bytes BANKED for the next cycle (see :func:`_bg_fluid` — a
        background connection is long-lived and does not restart at
        directive-cycle boundaries).  ``deliver_all_bg`` lifts both the
        window and the residual cap (solo drain at full capacity).
        """
        snd = np.asarray(snd, np.int64)
        rcv = np.asarray(rcv, np.int64)
        pair = snd * self.n + rcv
        upair, inv = np.unique(pair, return_inverse=True)
        counts = np.bincount(inv, minlength=len(upair)).astype(np.int64)
        F = len(upair)
        fs, fd = upair // self.n, upair % self.n
        # --- phase 1: foreground-only fair-share solve -----------------
        if F:
            tm = transport(fs, fd, counts, self.chunk_bytes,
                           self.up_bps, self.down_bps,
                           quantum_frac=self.net.quantum_frac,
                           device=self.device)
            self.n_solves += tm.n_solves
            cflow, cend = self._stamp_grid(tm, counts)
            cstart = pipeline_starts(cflow, cend)
            lat_pair = self.lat[fs] + self.lat[fd]
            # Per-transfer pipeline rank within its pair, emission order.
            order = np.argsort(inv, kind="stable")
            inv_s = inv[order]
            first = np.searchsorted(inv_s, inv_s)
            rank = np.arange(len(inv_s)) - first
            off = np.cumsum(counts) - counts
            pos = off[inv_s] + rank
            te = np.empty(len(snd), np.float64)
            ts = np.empty(len(snd), np.float64)
            te[order] = t0 + lat_pair[inv_s] + cend[pos]
            ts[order] = t0 + lat_pair[inv_s] + cstart[pos]
            fin = tm.finish.copy()
            fin[~np.isfinite(fin)] = 0.0
            window = float(np.max(fin, initial=0.0))
            barrier = t0 + float(np.max(fin + lat_pair, initial=0.0))
            rec = obs.get()
            if rec.enabled:
                # One flow per (sender, receiver) pair this cycle —
                # per-flow granularity keeps recordings tractable.
                rec.flows(track, fs, fd,
                          t0 + lat_pair, t0 + lat_pair + fin,
                          chunks=counts)
                rec.counter("net.flows_solved", F)
                rec.counter("net.chunks_moved", len(snd))
                rec.counter("net.bytes_moved",
                            len(snd) * self.chunk_bytes)
                rec.counter("net.fg_solves", tm.n_solves)
        else:
            ts = np.zeros(0, np.float64)
            te = np.zeros(0, np.float64)
            window = 0.0
            barrier = t0
        # --- phase 2: background over residual capacity ----------------
        # Idle cycles (no foreground, no drain) pause the background —
        # the tail shares the swarm's duty cycle, it gets no free
        # private channel.
        B = self._bg_src.size
        if B and (deliver_all_bg or window > 0.0):
            if F and not deliver_all_bg:
                w_bytes = counts.astype(np.float64) * self.chunk_bytes
                used_up = np.bincount(fs, weights=w_bytes,
                                      minlength=self.n)
                used_dn = np.bincount(fd, weights=w_bytes,
                                      minlength=self.n)
                res_up = np.maximum(self.up_bps - used_up / window, 0.0)
                res_dn = np.maximum(self.down_bps - used_dn / window,
                                    0.0)
            else:
                res_up, res_dn = self.up_bps, self.down_bps
            bpair = self._bg_src * self.n + self._bg_dst
            border = np.argsort(bpair, kind="stable")
            bsorted = bpair[border]
            newf = np.r_[True, bsorted[1:] != bsorted[:-1]]
            bflow_pair = bsorted[newf]
            flow_of = np.cumsum(newf) - 1      # sorted entry -> flow
            bfs = bflow_pair // self.n
            bfd = bflow_pair % self.n
            W = np.inf if deliver_all_bg else window
            bstart, bend, rem_after, nsol = _bg_fluid(
                bfs, bfd, flow_of, self._bg_rem[border],
                res_up, res_dn, W, self.net.quantum_frac,
                device=self.device)
            self.n_solves += nsol
            self._bg_rem[border] = rem_after
            oks = np.isfinite(bend)            # sorted-entry delivered
            rec = obs.get()
            if oks.any():
                blat = self.lat[bfs] + self.lat[bfd]
                q = border[oks]
                batch = {
                    "meta": self._bg_meta[q].copy(),
                    "src": self._bg_src[q].copy(),
                    "dst": self._bg_dst[q].copy(),
                    "t_start": t0 + blat[flow_of[oks]] + bstart[oks],
                    "t_end": t0 + blat[flow_of[oks]] + bend[oks]}
                self._bg_log.append(batch)
                if rec.enabled:
                    rec.flows("background", batch["src"], batch["dst"],
                              batch["t_start"], batch["t_end"])
                done = np.zeros(B, dtype=bool)
                done[q] = True
                self._bg_src = self._bg_src[~done]
                self._bg_dst = self._bg_dst[~done]
                self._bg_meta = self._bg_meta[~done]
                self._bg_rem = self._bg_rem[~done]
            if rec.enabled:
                # Residual-capacity fill for the async carry: how much
                # of the queued tail this cycle's idle bandwidth soaked.
                rec.event("net.bg_fill", t=t0,
                          window=(float(W) if np.isfinite(W) else -1.0),
                          queued=int(B), delivered=int(oks.sum()),
                          solves=int(nsol))
                rec.counter("net.bg_delivered", int(oks.sum()))
                rec.counter("net.bg_solves", int(nsol))
                rec.gauge("net.bg_backlog", int(self._bg_src.size))
        return ts, te, barrier

    # ------------------------------------------------------------------
    def spray(self, snd, rcv, chk):
        """Pre-round obfuscation over ephemeral tunnels: tunnel setup
        (control plane) then one fair-share transport of all sprays."""
        t0 = self.tracker.spray_setup(self.t, len(snd))
        if len(snd) == 0:
            self.t = t0
            return (np.zeros(0, np.float64), np.zeros(0, np.float64))
        ts, te, barrier = self._transport(snd, rcv, t0, track="spray")
        self.data_s += barrier - t0
        self.t = barrier
        return ts, te

    def warmup_cycle(self, slot: int, snd, rcv, chk):
        """One warm-up directive cycle: tracker RTT, then transport."""
        t0 = self.tracker.directive_cycle(slot, self.t, len(snd))
        if len(snd) == 0:
            self.t = t0                 # an idle cycle still ticks
            return (np.zeros(0, np.float64), np.zeros(0, np.float64))
        ts, te, barrier = self._transport(snd, rcv, t0, track="warmup")
        self.data_s += barrier - t0
        self.t = barrier
        return ts, te

    def bt_cycle(self, snd, rcv, chk):
        """One exact-BT swarming cycle: peer-driven, no tracker RTT."""
        if len(snd) == 0:
            return (np.zeros(0, np.float64), np.zeros(0, np.float64))
        ts, te, barrier = self._transport(snd, rcv, self.t, track="bt")
        self.data_s += barrier - self.t
        self.t = barrier
        return ts, te

    def advance(self, seconds: float):
        """Advance the wall clock (fluid BT phases report durations in
        count space; the engine just books the time)."""
        self.t += float(seconds)

    def control_log(self) -> dict:
        """The round's control-plane ledger plus the engine's data-path
        aggregates — the dict ``RoundResult.tracker_log`` carries (the
        merge used to live inline in the simulator; the typed obs
        events carry the same facts per cycle)."""
        return dict(self.tracker.as_log(), data_s=self.data_s,
                    n_solves=self.n_solves)

    # -- background (previous-generation) flows ------------------------
    def set_background(self, src, dst, meta):
        """Queue carried-over transfers (one CHUNK per entry) that soak
        the residual capacity of every subsequent foreground cycle at
        strict lower priority (the foreground never slows down).

        ``meta`` is an opaque per-entry id echoed back by
        :meth:`background_log` / :meth:`background_remaining` so the
        caller (the async session) can map deliveries to generation /
        owner bookkeeping.  Queue order is pipeline priority within each
        (src, dst) pair.  Background flows only progress while a
        foreground cycle is in flight (idle directive cycles pause them)
        — the tail shares the swarm's duty cycle instead of getting a
        free private channel.
        """
        self._bg_src = np.asarray(src, np.int64).copy()
        self._bg_dst = np.asarray(dst, np.int64).copy()
        self._bg_meta = np.asarray(meta, np.int64).copy()
        self._bg_rem = np.full(len(self._bg_src), self.chunk_bytes,
                               np.float64)
        if not (len(self._bg_src) == len(self._bg_dst)
                == len(self._bg_meta)):
            raise ValueError("background arrays must align")

    def drain_background(self):
        """Solo-transport the queued background to completion (no
        foreground contention): the synchronous-boundary tail drain of
        ``tail_mode="drain"``.  Advances the wall clock by the drain
        makespan and returns ``(meta, t_start, t_end)`` with stamps
        RELATIVE to the drain start."""
        t0 = self.t
        if self._bg_src.size == 0:
            z = np.zeros(0, np.float64)
            return np.zeros(0, np.int64), z, z
        mark = len(self._bg_log)
        self._transport(np.zeros(0, np.int64), np.zeros(0, np.int64),
                        t0, deliver_all_bg=True)
        batches = self._bg_log[mark:]
        meta = np.concatenate([b["meta"] for b in batches])
        ts = np.concatenate([b["t_start"] for b in batches]) - t0
        te = np.concatenate([b["t_end"] for b in batches]) - t0
        dur = float(te.max(initial=0.0))
        self.t = t0 + dur
        self.data_s += dur
        return meta, ts, te

    def background_log(self) -> dict:
        """All background deliveries so far: dict of aligned ``meta``,
        ``src``, ``dst``, ``t_start``, ``t_end`` arrays (absolute engine
        time)."""
        if not self._bg_log:
            z = np.zeros(0, np.float64)
            zi = np.zeros(0, np.int64)
            return {"meta": zi, "src": zi.copy(), "dst": zi.copy(),
                    "t_start": z, "t_end": z.copy()}
        return {k: np.concatenate([b[k] for b in self._bg_log])
                for k in ("meta", "src", "dst", "t_start", "t_end")}

    def background_remaining(self) -> np.ndarray:
        """Meta ids still queued (undelivered) — requeue for the next
        round's engine."""
        return self._bg_meta.copy()
