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
return numpy and run in between in torch float64 on
``resolve_device(device)`` (the GPU unless the caller names the CPU):
:func:`maxmin_rates` is a loop of at most ``max_passes`` bottleneck
levels over freeze masks (the same stall guard and truncated feasible
tail as the host fill), and :func:`transport` carries the whole segment
loop — water-fill solve, flow-death masking, quantum-batched finish
events and per-chunk crossing emission over the chunk grid in (flow,
rank) order — as device tensors, with one host read of the alive mask
per segment and one per fill level.  Each product and difference is its
own op (no fused multiply-add) and the per-link counts are sums of
1.0s, exact in any order, so the arithmetic is the host loops' IEEE
operation order: rates, finish and chunk instants are bit-equal to
theirs (the JAX kernels form a finish instant as ``t + ttf``, one ulp
away at most; the host loop, and so this one, as ``t + dt - dt + ttf``).

The numpy host loops (:func:`maxmin_rates_plain`,
:func:`transport_plain`) are kept verbatim as the plain versions the
tests and ``chip_smoke.py`` hold the device solvers against; nothing on
the simulator's path calls them.

Chunk-level completion instants come from the piecewise-linear
delivered-bytes curve of each flow: chunks are pipelined back-to-back
over the flow (BitTorrent keeps a connection's pipe full), so chunk
``j`` completes when ``j * chunk_bytes`` cumulative bytes have arrived.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import obs, resolve_device

_EPS = 1e-9
_F64 = torch.float64


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
    ``device``.
    """
    if len(src) == 0:
        return np.zeros(0, np.float64)
    s, d, u, w = _links(src, dst, up, down)
    rec = obs.get()
    if rec.enabled:
        rec.counter("fairshare.maxmin_calls")
    dev = resolve_device(device)
    link, cap, slack, ok = _device_links(s, d, u, w, dev)
    r = _maxmin_fill(link, cap, slack, ok, int(max_passes))
    return r.cpu().numpy()


def _device_links(src, dst, up, down, dev):
    """The 2n access links on ``dev``: uplinks, then downlinks.  Flow
    ``f`` crosses links ``link[f] = src[f]`` and ``link[F + f] = n +
    dst[f]``; returns ``link``, the capacities, their saturation
    slack (relative, so links of any magnitude compare fairly) and
    which flows have capacity on both their links."""
    n, f = len(up), len(src)
    link = torch.from_numpy(np.concatenate([src, dst + n])).to(dev)
    cap = torch.from_numpy(np.concatenate([up, down])).to(dev)
    slack = _EPS * torch.clamp(cap, min=1.0)
    ok = (cap > _EPS)[link].view(2, f).all(0)
    return link, cap, slack, ok


def _maxmin_fill(link, cap, slack, unfrozen, max_passes: int):
    """Progressive filling on device tensors (the JAX kernel's
    ``_maxmin_fill``) over the links of :func:`_device_links`: one pass
    per bottleneck level while any flow is unfrozen, freeze masks in
    place of boolean indexing, the same stall guard and truncated
    feasible tail.  Uplinks and downlinks sit in one vector, so a pass
    is half the launches of one per side; every value is the host
    fill's (the min over both sides is the min of the two mins).  Also
    run per segment by :func:`_transport_device`."""
    f = unfrozen.shape[0]
    inf = float("inf")

    def counts(unfrozen):
        # Sums of 1.0s: exact whatever order the device adds them in.
        wt = unfrozen.to(_F64).repeat(2)
        return torch.zeros_like(cap).index_add_(0, link, wt)

    rates = torch.zeros(f, dtype=_F64, device=cap.device)
    fill = torch.zeros((), dtype=_F64, device=cap.device)
    for _ in range(max_passes):
        if not bool(unfrozen.any()):
            break
        cnt = counts(unfrozen)
        used = cnt > 0
        t = torch.where(used, cap / cnt, inf).min()
        fill = fill + t
        cap = cap - t * cnt
        sat = used & (cap <= slack)
        freeze = unfrozen & sat[link].view(2, f).any(0)
        # Numerical stall (no link saturated): freeze everything.
        freeze = torch.where(freeze.any(), freeze, unfrozen)
        rates = torch.where(freeze, fill, rates)
        unfrozen = unfrozen ^ freeze        # freeze is within unfrozen
    # Truncated tail: one feasible min-share fill for the rest.
    cnt = counts(unfrozen)
    share = torch.where(cnt > 0, cap / cnt, inf)[link].view(2, f).amin(0)
    return torch.where(unfrozen, fill + torch.clamp(share, min=0.0), rates)


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
    runs in float64 on ``device``.
    """
    if len(src) == 0:
        return _no_flows()
    s, d, c, nbytes, u, w, quantum = _flows(
        src, dst, counts, chunk_bytes, up, down, quantum_frac)
    tm = _transport_device(s, d, c, nbytes, float(chunk_bytes), u, w,
                           quantum, resolve_device(device))
    rec = obs.get()
    if rec.enabled:
        # Every segment's fill is one max-min solve, counted as the host
        # loop counts its maxmin_rates calls.
        rec.counter("fairshare.maxmin_calls", tm.n_solves)
        rec.counter("fairshare.transport_calls")
        rec.counter("fairshare.solves", tm.n_solves)
    return tm


def _transport_device(src, dst, counts, nbytes, chunk_bytes, up, down,
                      quantum, dev, max_passes: int = 16):
    """The whole segment loop on device tensors (the JAX kernel's
    ``_transport_compiled``).

    The carry is the wall clock ``t``, per-flow residual bytes,
    delivered curve, finish instants, alive mask, the per-chunk
    completion grid ``cend`` in (flow, rank) order — precisely the host
    path's final ``lexsort((chunk_end, chunk_flow))`` order, because
    ends are strictly increasing with rank inside a flow — and the solve
    count.  A chunk row records its completion instant in the segment
    its 1-based rank is crossed by the flow's delivered-bytes curve;
    rows never crossed (dead flows) stay ``inf`` and are dropped at the
    end, reproducing the host path's emit-on-cross behaviour.
    """
    f = len(src)
    total = int(counts.sum())
    c_flow = np.repeat(np.arange(f, dtype=np.int64), counts)
    c_rank = (np.arange(total, dtype=np.int64)
              - np.repeat(np.cumsum(counts) - counts, counts) + 1)

    def put(a):
        return torch.from_numpy(a).to(dev)

    link, cap, slack, link_ok = _device_links(src, dst, up, down, dev)
    counts_f = put(counts.astype(np.float64))    # k1 clamp
    cf, cr = put(c_flow), put(c_rank)
    cr_f = cr.to(_F64)
    # A device tensor, not a Python float: CUDA divides a tensor by a
    # host scalar as a multiply by its reciprocal, a different rounding.
    cb = torch.tensor(chunk_bytes, dtype=_F64, device=dev)
    q = torch.tensor(quantum, dtype=_F64, device=dev)
    inf = float("inf")
    eps_cb = _EPS * cb

    rem = put(nbytes)
    alive = rem > 0
    t = torch.zeros((), dtype=_F64, device=dev)
    delivered = torch.zeros(f, dtype=_F64, device=dev)
    finish = torch.where(alive, inf, 0.0)
    cend = torch.full((total,), float("inf"), dtype=_F64, device=dev)
    n_solves = 0
    while bool(alive.any()):
        r = _maxmin_fill(link, cap, slack, alive & link_ok, max_passes)
        n_solves += 1
        live = alive & (r > _EPS)           # dead: no capacity, ever
        ttf = torch.where(live, rem / torch.where(live, r, 1.0), inf)
        tmin = ttf.min()
        dt = torch.where(torch.isfinite(tmin), torch.maximum(tmin, q), 0.0)
        adv = torch.where(live, torch.minimum(r * dt, rem), 0.0)
        old = delivered
        new = old + adv
        k0 = torch.floor(old / cb + _EPS).long()
        k1 = torch.minimum(torch.floor(new / cb + _EPS), counts_f).long()
        crossed = (cr > k0[cf]) & (cr <= k1[cf])
        endv = t + (cr_f * cb - old[cf]) / torch.where(crossed, r[cf], 1.0)
        cend = torch.where(crossed, endv, cend)
        rem = rem - adv
        done = live & (rem <= eps_cb)
        t_next = t + dt
        # Exact finish instants under the segment's constant rates,
        # formed as the host loop forms them (after the clock advanced).
        finish = torch.where(done, t_next - dt + ttf, finish)
        t = t_next
        delivered = new
        alive = live & ~done
    finish = finish.cpu().numpy()
    cend = cend.cpu().numpy()
    emitted = np.isfinite(cend)
    fin = finish[np.isfinite(finish)]
    return FlowTimings(finish=finish, chunk_flow=c_flow[emitted],
                       chunk_end=cend[emitted],
                       makespan=float(fin.max(initial=0.0)),
                       n_solves=n_solves)


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
