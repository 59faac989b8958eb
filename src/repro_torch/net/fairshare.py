"""Max-min fair-share flow allocation over access links (repro_torch.net).

The event engine models every scheduled (sender, receiver) pair of a
stage as one *flow* over two shared resources — the sender's uplink and
the receiver's downlink, both in raw bytes/s — and allocates rates by
**progressive filling**: all flows ramp together, a link saturates when
its remaining capacity divided by its unfrozen-flow count is reached,
flows crossing a saturated link freeze at the current fill level, and
the rest keep ramping.  The fixed point is the classic max-min fair
allocation (no flow's rate can grow without shrinking a smaller one).

Port of the JAX package's ``net/fairshare.py``.  Both solvers take and
return numpy and run in between in float64 on ``resolve_device(device)``
(the GPU unless the caller names the CPU).  On a CUDA device each call
is one launch of a hand-written kernel (``repro_torch.kernels.fairshare``,
``csrc/fairshare.cu``), the counterpart of the JAX package's compiled
programs: :func:`maxmin_rates` runs ``fairshare_maxmin``, every
bottleneck level of ``_maxmin_compiled``'s loop, and :func:`transport`
runs ``fairshare_transport``, the whole segment loop of
``_transport_compiled`` (water-fill solve, flow-death masking,
quantum-batched finish events and per-chunk crossing emission), each
with one packed copy in and one out.

On the CPU the wrappers run their plain PyTorch version, the torch
loop kept beside the kernels: the numpy host loops on tensors, with one
host read of the alive mask per segment and one per fill level.  Both
routes round each product, quotient, sum and difference on its own (no
fused multiply-add), and the per-link counts are sums of 1.0s, exact in
any order, so rates, finish and chunk instants are bit-equal to the
host loops' (the JAX kernels form a finish instant as ``t + ttf``, one
ulp away at most; the host loop, and so these, as ``t + dt - dt +
ttf``).

The numpy host loops (:func:`maxmin_rates_plain`,
:func:`transport_plain`) are kept verbatim as the oracle the tests and
``chip_smoke.py`` hold both routes against; nothing on the simulator's
path calls them.

Chunk-level completion instants come from the piecewise-linear
delivered-bytes curve of each flow: chunks are pipelined back-to-back
over the flow (BitTorrent keeps a connection's pipe full), so chunk
``j`` completes when ``j * chunk_bytes`` cumulative bytes have arrived.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import obs, resolve_device
from ..kernels import fairshare as kfs

_EPS = kfs.EPS


# ---------------------------------------------------------------------------
# max-min progressive filling
# ---------------------------------------------------------------------------

def _links(src, dst, up, down):
    """int64 flow endpoints and float64 link rates, as numpy arrays."""
    return (np.asarray(src, np.int64), np.asarray(dst, np.int64),
            np.asarray(up, np.float64), np.asarray(down, np.float64))


def maxmin_rates(src: np.ndarray, dst: np.ndarray,
                 up: np.ndarray, down: np.ndarray,
                 max_passes: int = 16, *, device=None) -> np.ndarray:
    """Max-min fair rates (bytes/s) for flows ``src[f] -> dst[f]``.

    ``up``/``down`` are per-peer access-link capacities in bytes/s.
    Flows whose uplink or downlink has no capacity get rate 0.

    Progressive filling freezes one bottleneck *level* per pass; with
    heterogeneous links a stage can have O(#links) distinct levels, so
    after ``max_passes`` exact levels the remaining (least-constrained)
    flows are finished with one feasible min-share fill — each takes
    ``fill + min(residual_up / n_up, residual_down / n_down)``, which
    never oversubscribes a link and coincides with the exact fixpoint
    whenever one pass would have finished anyway.  Small stages and the
    homogeneous limit are always exact.  Solved in float64 on
    ``device``: one ``fairshare_maxmin`` launch on a CUDA device, the
    torch loop on the CPU.
    """
    if len(src) == 0:
        return np.zeros(0, np.float64)
    s, d, u, w = _links(src, dst, up, down)
    rec = obs.get()
    if rec.enabled:
        rec.counter("fairshare.maxmin_calls")
    return kfs.fairshare_maxmin(s, d, u, w, int(max_passes),
                                device=resolve_device(device))


def maxmin_rates_plain(src: np.ndarray, dst: np.ndarray,
                       up: np.ndarray, down: np.ndarray,
                       max_passes: int = 16) -> np.ndarray:
    """Plain numpy version of :func:`maxmin_rates` (the JAX package's
    host fill, verbatim): the reference the device solver is held to."""
    if len(src) == 0:
        return np.zeros(0, np.float64)
    return _maxmin_host(*_links(src, dst, up, down), max_passes)


def _maxmin_host(src, dst, up, down, max_passes):
    """Host progressive filling."""
    f = src.size
    n = len(up)
    cap_up = up.copy()
    cap_down = down.copy()
    rates = np.zeros(f, np.float64)
    unfrozen = (cap_up[src] > _EPS) & (cap_down[dst] > _EPS)
    fill = 0.0
    slack_u = _EPS * np.maximum(up, 1.0)
    slack_d = _EPS * np.maximum(down, 1.0)
    # Each pass saturates >= 1 link, so <= 2n passes; the tail fill
    # bounds the worst case.
    for _ in range(max_passes):
        if not unfrozen.any():
            return rates
        nu = np.bincount(src[unfrozen], minlength=n).astype(np.float64)
        nd = np.bincount(dst[unfrozen], minlength=n).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            tu = np.where(nu > 0, cap_up / nu, np.inf)
            td = np.where(nd > 0, cap_down / nd, np.inf)
        t = min(tu.min(), td.min())
        fill += t
        cap_up -= t * nu
        cap_down -= t * nd
        # Freeze flows through any just-saturated link (relative slack
        # so heterogeneous-magnitude links compare fairly).
        sat_u = (nu > 0) & (cap_up <= slack_u)
        sat_d = (nd > 0) & (cap_down <= slack_d)
        freeze = unfrozen & (sat_u[src] | sat_d[dst])
        if not freeze.any():        # numerical stall: freeze everything
            freeze = unfrozen
        rates[freeze] = fill
        unfrozen &= ~freeze
    if unfrozen.any():
        # Truncated tail: one feasible min-share fill for the rest.
        nu = np.bincount(src[unfrozen], minlength=n).astype(np.float64)
        nd = np.bincount(dst[unfrozen], minlength=n).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            su = np.where(nu > 0, cap_up / nu, np.inf)
            sd = np.where(nd > 0, cap_down / nd, np.inf)
        share = np.minimum(su[src], sd[dst])
        rates[unfrozen] = fill + np.maximum(share[unfrozen], 0.0)
    return rates


# ---------------------------------------------------------------------------
# chunked transport
# ---------------------------------------------------------------------------

@dataclass
class FlowTimings:
    """Result of :func:`transport`.

    ``finish``      (F,) completion instant of each flow (relative to
                    the stage start, seconds).
    ``chunk_flow``  (M,) flow index of each delivered chunk, grouped by
                    flow in pipeline order (chunk rank ascending).
    ``chunk_end``   (M,) completion instant of each chunk.
    ``makespan``    instant the last flow finished.
    ``n_solves``    water-filling re-solves performed (diagnostics).
    """

    finish: np.ndarray
    chunk_flow: np.ndarray
    chunk_end: np.ndarray
    makespan: float
    n_solves: int

    def chunk_starts(self) -> np.ndarray:
        """Pipelined start instant of each chunk (see
        :func:`pipeline_starts`)."""
        return pipeline_starts(self.chunk_flow, self.chunk_end)


def pipeline_starts(chunk_flow: np.ndarray,
                    chunk_end: np.ndarray) -> np.ndarray:
    """Pipelined start instant of each chunk: the previous chunk's
    completion within the same flow (0.0 for each flow's first).
    ``chunk_flow`` must be grouped by flow with ``chunk_end``
    non-decreasing within each group."""
    starts = np.zeros_like(chunk_end)
    if len(starts) == 0:
        return starts
    same = np.zeros(len(starts), dtype=bool)
    same[1:] = chunk_flow[1:] == chunk_flow[:-1]
    starts[same] = chunk_end[:-1][same[1:]]
    return starts


def congestion_bound(src: np.ndarray, dst: np.ndarray,
                     nbytes: np.ndarray, up: np.ndarray,
                     down: np.ndarray) -> float:
    """Congestion lower bound (seconds) on moving ``nbytes[f]`` bytes
    over flows ``src[f] -> dst[f]``: no transport discipline can beat
    the busiest access link.  The canonical implementation — both the
    transport quantum sizing below and the time-domain efficiency
    denominator (:func:`repro_torch.core.maxflow.stage_time_lower_bound`)
    use it, so the two can never desynchronize."""
    n = len(up)
    out_b = np.bincount(src, weights=nbytes, minlength=n)
    in_b = np.bincount(dst, weights=nbytes, minlength=n)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_up = np.where(out_b > 0, out_b / np.maximum(
            np.asarray(up, np.float64), _EPS), 0.0)
        t_dn = np.where(in_b > 0, in_b / np.maximum(
            np.asarray(down, np.float64), _EPS), 0.0)
    return float(max(t_up.max(initial=0.0), t_dn.max(initial=0.0)))


def _flows(src, dst, counts, chunk_bytes, up, down, quantum_frac):
    """Typed flow arrays, per-flow bytes and the re-solve quantum: a
    ``quantum_frac`` share of the congestion lower bound on the
    makespan (the busiest access link)."""
    s, d, u, w = _links(src, dst, up, down)
    c = np.asarray(counts, np.int64)
    nbytes = c.astype(np.float64) * float(chunk_bytes)
    quantum = quantum_frac * congestion_bound(s, d, nbytes, u, w)
    return s, d, c, nbytes, u, w, quantum


def _no_flows() -> FlowTimings:
    return FlowTimings(np.zeros(0), np.zeros(0, np.int64), np.zeros(0),
                       0.0, 0)


def transport(src: np.ndarray, dst: np.ndarray, counts: np.ndarray,
              chunk_bytes: float, up: np.ndarray, down: np.ndarray,
              *, quantum_frac: float = 1 / 64,
              device=None) -> FlowTimings:
    """Simulate max-min fair-share transport of chunked flows.

    Flow ``f`` carries ``counts[f]`` pipelined chunks of ``chunk_bytes``
    bytes from ``src[f]`` to ``dst[f]``.  Rates are re-solved at flow
    finish events, batched on a time quantum of ``quantum_frac`` of the
    congestion lower bound so the number of solves stays bounded: a
    flow finishing mid-segment still records its *exact* finish instant
    under its current rate; only the redistribution of its freed
    capacity waits for the segment boundary.  ``quantum_frac=0`` gives
    the exact per-event progressive-filling process.  The segment loop
    runs in float64 on ``device``: one ``fairshare_transport`` launch on
    a CUDA device, the torch loop on the CPU.
    """
    if len(src) == 0:
        return _no_flows()
    s, d, c, nbytes, u, w, quantum = _flows(
        src, dst, counts, chunk_bytes, up, down, quantum_frac)
    finish, cend, n_solves = kfs.fairshare_transport(
        s, d, c, nbytes, float(chunk_bytes), u, w, quantum,
        device=resolve_device(device))
    emitted = np.isfinite(cend)
    fin = finish[np.isfinite(finish)]
    tm = FlowTimings(finish=finish,
                     chunk_flow=np.repeat(
                         np.arange(len(s), dtype=np.int64), c)[emitted],
                     chunk_end=cend[emitted],
                     makespan=float(fin.max(initial=0.0)),
                     n_solves=n_solves)
    rec = obs.get()
    if rec.enabled:
        # Every segment's fill is one max-min solve, counted as the host
        # loop counts its maxmin_rates calls.
        rec.counter("fairshare.maxmin_calls", tm.n_solves)
        rec.counter("fairshare.transport_calls")
        rec.counter("fairshare.solves", tm.n_solves)
    return tm


def transport_plain(src: np.ndarray, dst: np.ndarray, counts: np.ndarray,
                    chunk_bytes: float, up: np.ndarray, down: np.ndarray,
                    *, quantum_frac: float = 1 / 64) -> FlowTimings:
    """Plain numpy version of :func:`transport` (the JAX package's host
    segment loop, verbatim): the reference the device loop is held
    to."""
    if len(src) == 0:
        return _no_flows()
    s, d, c, nbytes, u, w, quantum = _flows(
        src, dst, counts, chunk_bytes, up, down, quantum_frac)
    return _transport_host(s, d, c, nbytes, float(chunk_bytes), u, w,
                           quantum)


def _transport_host(src, dst, counts, nbytes, chunk_bytes, up, down,
                    quantum):
    """Host segment loop."""
    f = src.size
    rem = nbytes.copy()
    delivered = np.zeros(f, np.float64)
    finish = np.full(f, np.inf, np.float64)
    alive = rem > 0
    finish[~alive] = 0.0

    cf_parts: list[np.ndarray] = []
    ce_parts: list[np.ndarray] = []
    t = 0.0
    n_solves = 0
    while alive.any():
        idx = np.flatnonzero(alive)
        r = _maxmin_host(src[idx], dst[idx], up, down, 16)
        n_solves += 1
        dead = r <= _EPS
        if dead.any():
            # No capacity left for these flows (caller scheduled onto a
            # zero-rate link): they can never complete.
            alive[idx[dead]] = False
            idx, r = idx[~dead], r[~dead]
            if idx.size == 0:
                break
        ttf = rem[idx] / r
        dt = max(float(ttf.min()), quantum)
        adv = np.minimum(r * dt, rem[idx])
        # Chunk boundaries crossed inside this segment, per flow.
        old = delivered[idx]
        new = old + adv
        k0 = np.floor(old / chunk_bytes + _EPS).astype(np.int64)
        k1 = np.minimum(np.floor(new / chunk_bytes + _EPS), counts[idx]
                        ).astype(np.int64)
        ncross = k1 - k0
        if ncross.sum() > 0:
            which = np.flatnonzero(ncross > 0)
            reps = ncross[which]
            fl = np.repeat(idx[which], reps)
            base = np.repeat(k0[which], reps)
            off = np.arange(reps.sum()) - np.repeat(
                np.cumsum(reps) - reps, reps)
            kk = base + off + 1                     # 1-based chunk rank
            rr = np.repeat(r[which], reps)
            oo = np.repeat(old[which], reps)
            ce_parts.append(t + (kk * chunk_bytes - oo) / rr)
            cf_parts.append(fl)
        t += dt
        delivered[idx] = new
        rem[idx] -= adv
        done = rem[idx] <= _EPS * chunk_bytes
        if done.any():
            # Exact finish instants under the segment's constant rates.
            finish[idx[done]] = t - dt + ttf[done]
            alive[idx[done]] = False

    if cf_parts:
        chunk_flow = np.concatenate(cf_parts)
        chunk_end = np.concatenate(ce_parts)
        o = np.lexsort((chunk_end, chunk_flow))
        chunk_flow, chunk_end = chunk_flow[o], chunk_end[o]
    else:
        chunk_flow = np.zeros(0, np.int64)
        chunk_end = np.zeros(0, np.float64)
    fin = finish[np.isfinite(finish)]
    makespan = float(fin.max(initial=0.0))
    return FlowTimings(finish=finish, chunk_flow=chunk_flow,
                       chunk_end=chunk_end, makespan=makespan,
                       n_solves=n_solves)
