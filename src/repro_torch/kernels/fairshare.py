"""The event engine's fair-share solvers as one CUDA launch a call.

The JAX package compiles each solver of its ``net/fairshare.py`` into
one device program, and no Pallas kernel is behind either:
``maxmin_rates`` runs ``_maxmin_compiled``, one ``lax.while_loop`` over
bottleneck levels, and ``transport`` runs ``_transport_compiled``, the
whole segment loop in one ``lax.while_loop``.  ``csrc/fairshare.cu``
holds their counterparts:

* ``fairshare_maxmin``    — max-min fair rates: every bottleneck level
                            of progressive filling and the truncated
                            tail fill in one launch;
* ``fairshare_transport`` — every segment of a transport call in one
                            launch: the solve, the dead flows, the time
                            step, the advance, the chunk crossings and
                            the finish instants; writes the finish
                            instants, the chunk ends in (flow, rank)
                            order and the solve count.

Each runs in one CTA, the 2n access links in its shared memory, so the
number of peers is bounded by the device's shared memory
(``fairshare_max_peers``; a ``ValueError`` past it).  The kernels round
every operation as the numpy host loops of ``net/fairshare.py`` do, and
give their bits.

The wrappers take the numpy arrays of ``net/fairshare.py`` and a
device.  On a CUDA device a call packs its inputs into one float64
buffer (one host-to-device copy), launches its kernel once, counted in
``LAUNCHES``, and copies one packed output buffer back.  A transport
call whose segment loop runs past ``max_segments`` raises; nothing
falls back.  On the CPU, or with ``impl="torch"``, a wrapper runs the
plain PyTorch version kept beside the kernels: the torch loop
(:func:`_maxmin_fill`, :func:`_transport_device`), the numpy host loops
of ``net/fairshare.py`` on tensors, with one host read of the alive
mask a segment and one a fill level.  It rounds each product,
quotient, sum and difference on its own, as the kernels do.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build

EPS = 1e-9      # saturation and crossing tolerance; csrc's kEps
_F64 = torch.float64


def watchdog_segments(f: int) -> int:
    """The default segment cap of a transport call over ``f`` flows.

    Every segment finishes the flow with the least time to finish (the
    step is at least that time) or drops every dead flow, so a call
    runs at most ``f`` segments; the cap is twice that, plus 1024."""
    return 2 * f + 1024


def _plain(name: str, device: torch.device, impl: str) -> bool:
    if impl not in ("cuda", "torch"):
        raise ValueError(f"unknown {name} impl {impl!r}")
    return impl == "torch" or device.type == "cpu"


@functools.lru_cache(maxsize=None)
def max_peers(device_index: int) -> int:
    """The most peers whose 2n links fit one CTA's shared memory on
    the CUDA device ``device_index`` (the launch checks it again)."""
    return int(_build.extension().fairshare_max_peers(device_index))


def _put(device: torch.device, n: int, *parts) -> torch.Tensor:
    """The packed float64 input buffer on ``device``: one copy."""
    most = max_peers(device.index if device.index is not None
                     else torch.cuda.current_device())
    if n > most:
        raise ValueError(
            f"fair-share kernels: the {2 * n} access links of n = {n} peers "
            f"do not fit one CTA's shared memory on this device (at most "
            f"n = {most} peers)")
    buf = np.concatenate([np.asarray(p, np.float64).ravel()
                          for p in parts])
    return torch.from_numpy(buf).to(device)


def _device_links(src, dst, up, down, dev):
    """The 2n access links on ``dev``: uplinks, then downlinks.  Flow
    ``f`` crosses links ``link[f] = src[f]`` and ``link[F + f] = n +
    dst[f]``; returns ``link``, the capacities, their saturation
    slack (relative, so links of any magnitude compare fairly) and
    which flows have capacity on both their links."""
    n, f = len(up), len(src)
    link = torch.from_numpy(np.concatenate([src, dst + n])).to(dev)
    cap = torch.from_numpy(np.concatenate([up, down])).to(dev)
    slack = EPS * torch.clamp(cap, min=1.0)
    ok = (cap > EPS)[link].view(2, f).all(0)
    return link, cap, slack, ok


def _maxmin_fill(link, cap, slack, unfrozen, max_passes: int):
    """Progressive filling on device tensors (the host fill on tensors;
    the plain version of ``fairshare_maxmin``) over the links of
    :func:`_device_links`: one pass per bottleneck level while any flow
    is unfrozen, freeze masks in place of boolean indexing, the same
    stall guard and truncated feasible tail.  Uplinks and downlinks sit
    in one vector, so a pass is half the launches of one per side; every
    value is the host fill's (the min over both sides is the min of the
    two mins).  Also run per segment by :func:`_transport_device`."""
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


def maxmin_args(src, dst, up, down, device: torch.device) -> dict:
    """The tensors of a ``fairshare_maxmin`` launch on ``device``."""
    f, n = len(src), len(up)
    return {"buf": _put(device, n, up, down, src, dst),
            "out": torch.empty(f + 1, dtype=_F64, device=device),
            "flags": torch.empty(f, dtype=torch.uint8, device=device),
            "n": n}


def launch_maxmin(a: dict, max_passes: int) -> None:
    _build.extension().fairshare_maxmin(a["buf"], a["out"], a["flags"],
                                        a["n"], int(max_passes))
    _build.LAUNCHES["fairshare_maxmin"] += 1


def fairshare_maxmin(src, dst, up, down, max_passes: int = 16, *,
                     device: torch.device, impl: str = "cuda"
                     ) -> np.ndarray:
    """Max-min fair rates of flows ``src[f] -> dst[f]`` over the links
    ``up``/``down`` (int64 and float64 numpy arrays), solved on
    ``device``: ``net/fairshare.py``'s ``maxmin_rates``."""
    if _plain("fairshare_maxmin", device, impl):
        link, cap, slack, ok = _device_links(src, dst, up, down, device)
        return _maxmin_fill(link, cap, slack, ok,
                            int(max_passes)).cpu().numpy()
    a = maxmin_args(src, dst, up, down, device)
    launch_maxmin(a, max_passes)
    return a["out"].cpu().numpy()[:len(src)]


def _transport_device(src, dst, counts, nbytes, chunk_bytes, up, down,
                      quantum, dev, max_passes: int = 16):
    """The host segment loop on device tensors: the plain version of
    ``fairshare_transport``, with one host read of the alive mask a
    segment (and one a fill level in :func:`_maxmin_fill`).

    The carry is the wall clock ``t``, per-flow residual bytes,
    delivered curve, finish instants, alive mask, the per-chunk
    completion grid ``cend`` in (flow, rank) order — precisely the host
    path's final ``lexsort((chunk_end, chunk_flow))`` order, because
    ends are strictly increasing with rank inside a flow — and the solve
    count.  A chunk row records its completion instant in the segment
    its 1-based rank is crossed by the flow's delivered-bytes curve;
    rows never crossed (dead flows) stay ``inf``; ``net/fairshare.py``'s
    ``transport`` drops them, reproducing the host path's emit-on-cross behaviour.
    Returns the finish instants, the chunk grid and the solve count.
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
    eps_cb = EPS * cb

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
        live = alive & (r > EPS)           # dead: no capacity, ever
        ttf = torch.where(live, rem / torch.where(live, r, 1.0), inf)
        tmin = ttf.min()
        dt = torch.where(torch.isfinite(tmin), torch.maximum(tmin, q), 0.0)
        adv = torch.where(live, torch.minimum(r * dt, rem), 0.0)
        old = delivered
        new = old + adv
        k0 = torch.floor(old / cb + EPS).long()
        k1 = torch.minimum(torch.floor(new / cb + EPS), counts_f).long()
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
    return finish.cpu().numpy(), cend.cpu().numpy(), n_solves


def transport_args(src, dst, counts, nbytes, chunk_bytes: float, up, down,
                   quantum: float, device: torch.device) -> dict:
    """The tensors of a ``fairshare_transport`` launch on ``device``."""
    f, n, m = len(src), len(up), int(counts.sum())
    kw = dict(dtype=_F64, device=device)
    return {"buf": _put(device, n, up, down, src, dst, counts,
                        np.cumsum(counts) - counts, nbytes,
                        [chunk_bytes, quantum]),
            "out": torch.empty(f + m + 3, **kw),
            "scratch": torch.empty(3 * f, **kw),
            "flags": torch.empty(f, dtype=torch.uint8, device=device),
            "n": n}


def launch_transport(a: dict, max_passes: int, max_segments: int) -> None:
    _build.extension().fairshare_transport(
        a["buf"], a["out"], a["scratch"], a["flags"], a["n"],
        int(max_passes), int(max_segments))
    _build.LAUNCHES["fairshare_transport"] += 1


def fairshare_transport(src, dst, counts, nbytes, chunk_bytes: float, up,
                        down, quantum: float, max_passes: int = 16, *,
                        device: torch.device, impl: str = "cuda",
                        max_segments: int | None = None):
    """The segment loop of ``net/fairshare.py``'s ``transport`` on
    ``device``: flow ``f`` moves ``counts[f]`` chunks (``nbytes[f]``
    bytes) of ``chunk_bytes`` from ``src[f]`` to ``dst[f]``, rates
    re-solved a segment at most ``quantum`` seconds apart.  Returns the
    finish instants (F,), the chunk ends (M,) in (flow, rank) order
    (``inf`` where a dead flow never crossed its chunk) and the solve
    count.  The kernel raises ``RuntimeError`` when flows are still
    alive after ``max_segments`` segments (default
    :func:`watchdog_segments`)."""
    if _plain("fairshare_transport", device, impl):
        return _transport_device(src, dst, counts, nbytes, chunk_bytes, up,
                                 down, quantum, device, max_passes)
    f, m = len(src), int(counts.sum())
    cap = watchdog_segments(f) if max_segments is None else max_segments
    a = transport_args(src, dst, counts, nbytes, chunk_bytes, up, down,
                       quantum, device)
    launch_transport(a, max_passes, cap)
    out = a["out"].cpu().numpy()
    segments, status = int(out[f + m]), out[f + m + 1]
    if status:
        raise RuntimeError(
            f"fairshare_transport: flows still alive after the watchdog's "
            f"{segments} segments ({f} flows, {m} chunks)")
    return out[:f], out[f:f + m], segments
