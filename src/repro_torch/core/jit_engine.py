"""GPU slot engine: fixed-shape budgeted-round matching on packed bitplanes.

Port of the JAX package's third slot engine (``repro/core/jit_engine.py``,
``SwarmConfig.scheduler_impl="jit"``).  It runs the inner budgeted-round
matching of the batched engine (feasible-sender selection, GFF
loser-retry, grouped-cumsum uplink splits, tau concurrency gating,
non-owner-first two-tier grants and rarest-first prefix extraction)
over packed 32-bit bitplanes on a torch device: the GPU unless the
caller names the CPU (``resolve_device``; the round's simulator stores
its device on the state as ``_jit_device``).

Contract (the JAX package's docs/INVARIANTS.md "jit-engine contract"):

* **fixed shapes**: candidate columns pad to a power-of-two count and
  pack into ``W = m_pad/32`` words; grants extract into a ``t_cap``-wide
  buffer and rounds run under a static ``r_max`` bound.  Pad bits are
  zero in both the supply and the need planes, so padding can never add
  a transfer.
* **masked convergence**: every round updates all receivers under
  boolean masks; the Python round loop stops the first round that finds
  no feasible (receiver, sender) pair, which costs the round's one
  device-to-host read.
* **schedule legality is engine-independent**: budgets, tau, adjacency,
  duplicate-freedom and the Eq. 1 gate hold as in the loop and batched
  engines.

Where the JAX package stages one ``lax.while_loop``, the port runs the
rounds as a Python loop of torch ops, with the plane work in three hand
kernels (``kernels/slots.py``: ``slot_planes`` once a slot,
``overlap_rank`` and ``extract_ranked`` once a round).  A slot makes one
host read a round plus one for the grant grids (``COUNTS``).

Words are int32 tensors with the uint32 bit patterns of the JAX
package's words.  The swarm-wide inventory lives on the device as a
packed ``(n, ceil(nK/32))`` plane, synced incrementally from the
transfer log by an in-place accumulating scatter (delivery exactly once
makes add and OR the same), so a slot never re-reads the O(n * nK)
boolean ``have`` matrix.

Randomness: exactly two host draws a slot from ``state.rng``, the
rarest-first tie-break and then one 31-bit seed, in the JAX package's
order, so the spray, lags and later slots draw what they draw there.
The seed keys the three noise bases of ``_slot_rounds``.  JAX draws them
with ``jax.random.bits``, which torch cannot reproduce, so here they are
an argument, drawn by ``_draw_bases`` from a CPU ``torch.Generator``
seeded with the slot's seed and uploaded: a seed gives the same schedule
byte for byte on the card and on the CPU.  The tests replace
``_draw_bases`` with JAX's own draw to hold the port byte-equal to the
JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..kernels import slots as _k
# the bitplane helpers keep the JAX package's names in this module too
from ..kernels.slots import (_extract_ranked, _first_bits,  # noqa: F401
                             _kth_set_bit, _mul32, _rank_counts, _u32)
from .state import SwarmState

_MODE_IDS = {"random_fifo": 0, "random_fastest_first": 1,
             "greedy_fastest_first": 2}
_GFF_RETRIES = 3          # loser re-picks per round, as the batched engine
_BIG = 1 << 30            # "unbounded" batch cap for the BT phase
_U01 = 2.0 ** -32         # uint32 -> [0, 1)

# Host-observed wall seconds per engine phase, accumulated across slots
# ("matching" includes the noise draw and the blocking device-to-host
# fetch of the grids).  The measurement clock is injected by the
# benchmarks (set_clock, or simulator.measured_clock); simulated time
# never reads the host clock, so by default the accumulators stay zero.
PHASE_S = {"bitplane_s": 0.0, "matching_s": 0.0, "extraction_s": 0.0}

# Work counts accumulated across slots: slots matched, grant rounds run
# and device-to-host reads (one a round, one for the grids).
COUNTS = {"slots": 0, "rounds": 0, "host_reads": 0}


def _zero_clock() -> float:
    return 0.0


_clock = _zero_clock


def set_clock(fn) -> None:
    """Install a wall-clock source for the PHASE_S accumulators (pass
    ``None`` to restore the zero clock).  Benchmark-only."""
    global _clock
    _clock = fn if fn is not None else _zero_clock


def reset_phase_timers() -> dict:
    """Zero the accumulators, returning the values they held."""
    held = dict(PHASE_S)
    for k in PHASE_S:
        PHASE_S[k] = 0.0
    return held


def reset_counts() -> dict:
    """Zero ``COUNTS``, returning the values it held."""
    held = dict(COUNTS)
    for k in COUNTS:
        COUNTS[k] = 0
    return held


def _empty():
    return (np.zeros(0, np.int64), np.zeros(0, np.int64),
            np.zeros(0, np.int64))


def _pow2(x: int) -> int:
    """Smallest power of two >= x (>= 1): pads every data-dependent
    extent to a small set of static shapes."""
    return 1 << max(int(x) - 1, 0).bit_length()


def _pack_words(bits: np.ndarray, w: int) -> np.ndarray:
    """(n, m) bool -> (n, w) uint32, bit ``c & 31`` of word ``c >> 5``
    is column ``c`` (little-endian bit order; pad bits stay zero)."""
    p = np.packbits(bits, axis=1, bitorder="little")
    buf = np.zeros((bits.shape[0], w * 4), dtype=np.uint8)
    buf[:, :p.shape[1]] = p
    words = buf.view(np.uint32)
    if not np.little_endian:            # pragma: no cover - x86/arm are LE
        words = words.byteswap()
    return words


def _device(state: SwarmState) -> torch.device:
    """The engine's device: the state's ``_jit_device`` (set by the
    round's simulator), else the GPU, which raises where there is none."""
    dev = getattr(state, "_jit_device", None)
    if dev is None:
        dev = resolve_device(None)
        state._jit_device = dev
    return dev


def _upload(a: np.ndarray, dev) -> torch.Tensor:
    """A host array on ``dev``; uint32 keeps its bits as int32."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(dev)


def _neighbor_lists(state: SwarmState) -> torch.Tensor:
    """Padded (n, d_pad) int32 neighbor lists (-1 pad) for the round's
    static overlay, device-cached so every slot reuses one upload."""
    cached = getattr(state, "_jit_nbr_cache", None)
    if cached is not None:
        return cached
    adj = state.adj
    n = adj.shape[0]
    deg = adj.sum(axis=1)
    d_pad = _pow2(max(int(deg.max(initial=1)), 1))
    nbr = np.full((n, d_pad), -1, dtype=np.int32)
    rows, cols = np.nonzero(adj)
    first = np.searchsorted(rows, np.arange(n))
    nbr[rows, np.arange(rows.size) - first[rows]] = cols
    dev = _upload(nbr, _device(state))
    state._jit_nbr_cache = dev
    return dev


def _scatter_bits(words: torch.Tensor, rows, wcol, vals) -> torch.Tensor:
    # Delivery-exactly-once (state.apply_transfers de-dups against
    # ``have``) keeps every (row, chunk) bit unique for the whole round,
    # so add == bitwise-or; pad entries carry vals == 0.  In place.
    return words.index_put_((rows.long(), wcol.long()), vals,
                            accumulate=True)


def _log_scatter(state: SwarmState, pos: int, nb: int):
    """Scatter operands (rows, word column, bit value) for transfer-log
    batches ``[pos:nb)``, padded to a power of two with zero values, on
    the engine's device (vals: uint32 bits as int32)."""
    if pos < nb:
        rcv = np.concatenate(state.log.receivers[pos:nb])
        chk = np.concatenate(state.log.chunks[pos:nb])
    else:
        rcv = np.zeros(0, np.int32)
        chk = np.zeros(0, np.int64)
    pad = _pow2(rcv.size)
    rows = np.zeros(pad, dtype=np.int32)
    wcol = np.zeros(pad, dtype=np.int32)
    vals = np.zeros(pad, dtype=np.uint32)
    rows[:rcv.size] = rcv
    wcol[:rcv.size] = chk >> 5
    vals[:rcv.size] = np.left_shift(
        np.uint32(1), (chk & 31).astype(np.uint32))
    dev = _device(state)
    return _upload(rows, dev), _upload(wcol, dev), _upload(vals, dev)


def _diag_words(state: SwarmState, w_full: int) -> np.ndarray:
    """Packed owner-diagonal inventory (client v holds exactly chunks
    [vK, vK+K)), the analytic post-construction state, built directly
    in the bit domain."""
    n = state.cfg.n
    K = state.cfg.chunks_per_update
    v = np.arange(n, dtype=np.int64)
    lo = (v * K)[:, None]
    wj = lo // 32 + np.arange(K // 32 + 2)[None, :]
    s = np.clip(lo - 32 * wj, 0, 32).astype(np.uint64)
    e = np.clip(lo + K - 32 * wj, 0, 32).astype(np.uint64)
    mask = (((np.uint64(1) << e) - 1)
            ^ ((np.uint64(1) << s) - 1)).astype(np.uint32)
    words = np.zeros((n, w_full), dtype=np.uint32)
    np.bitwise_or.at(
        words,
        (np.broadcast_to(v[:, None], wj.shape),
         np.minimum(wj, w_full - 1)),
        np.where(wj < w_full, mask, np.uint32(0)))
    return words


def _sync_have_dev(state: SwarmState) -> torch.Tensor:
    """Device copy of the packed swarm inventory, synced incrementally.

    The transfer log is the single write path for ``state.have`` after
    construction, so replaying batches appended since the last call
    reproduces the matrix bit for bit.  A swapped ``have`` identity
    (Byzantine claimed inventories) falls back to a full repack.
    """
    nb = len(state.log.receivers)
    cache = getattr(state, "_jit_have_cache", None)
    if cache is not None and cache[0] is state.have:
        dev, pos = cache[1], cache[2]
        if pos < nb:
            dev = _scatter_bits(dev, *_log_scatter(state, pos, nb))
        state._jit_have_cache = (state.have, dev, nb)
        return dev
    w_full = -(-state.have.shape[1] // 32)
    if cache is None and state.have is getattr(
            state, "_have_pristine", None):
        # First build of the genuine inventory: the owner diagonal is
        # analytic and the log already records every later delivery, so
        # packing in the bit domain skips an np.packbits pass over the
        # multi-GB bool matrix.
        dev = _scatter_bits(_upload(_diag_words(state, w_full),
                                    _device(state)),
                            *_log_scatter(state, 0, nb))
        state._jit_have_cache = (state.have, dev, nb)
        return dev
    dev = _upload(_pack_words(state.have, w_full), _device(state))
    state._jit_have_cache = (state.have, dev, nb)
    return dev


# ----------------------------------------------------------------------
# Device side
# ----------------------------------------------------------------------

def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit finalizer hash of each word's uint32 value: one fresh
    tie-break lattice per round and retry from a single per-slot base.
    Returns the uint32 results held in int64."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _salted(base: torch.Tensor, salt: int) -> torch.Tensor:
    """uint32 ``base ^ salt`` hashed to floats in [0, 1), as the JAX
    package's ``mix32(...).astype(f32) * 2**-32``."""
    return _mix32(base ^ (salt & 0xFFFFFFFF)).to(torch.float32) * _U01


def _draw_bases(seed: int, n: int, d_pad: int):
    """The slot's noise, tie and priority bases: (n, d_pad), (n,) and
    (n,) int32 words from a CPU ``torch.Generator`` seeded with the
    slot's seed, so every device draws the same bits."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    lo, hi = -(1 << 31), 1 << 31
    noise = torch.randint(lo, hi, (n, d_pad), generator=gen,
                          dtype=torch.int32)
    tie = torch.randint(lo, hi, (n,), generator=gen, dtype=torch.int32)
    prio = torch.randint(lo, hi, (n,), generator=gen, dtype=torch.int32)
    return noise, tie, prio


def _slot_rounds(mode_id: int, nonowner: bool, ungated: bool,
                 t_cap: int, r_max: int, have_dev, cand, owner_row,
                 own_allowed, m_cnt: int, recv_ok, nbr, rem_up, rem_down,
                 batch_cap: int, tau: int, bases):
    """One slot: plane build plus budgeted-round matching.

    Stage 1 (``slot_planes``) gathers the candidate columns out of the
    device-resident packed inventory in rarest-first bit order and
    applies the owner-window gate.  Stage 2 loops over grant rounds,
    carrying the need planes, the remaining uplink/downlink and tau
    budgets, the serving and tombstone pair masks and the fixed-shape
    output grids; every round is fully masked.  ``bases`` are the
    (noise (n, d_pad), tie (n,), prio (n,)) int32 words that the JAX
    package draws from ``seed`` inside its kernel.  The plane kernels
    run on CUDA tensors, their plain versions on CPU ones.

    Returns ``(out_snd, out_col, rounds)``: per (round, receiver) the
    granted sender (-1 none) and its rarest-first column batch (-1 pad),
    non-owner tier first within each grant, as (r_max, n) and (r_max,
    n, t_cap) int32 grids on the device (rows past ``rounds`` are -1),
    and how many rounds ran.
    """
    n = have_dev.shape[0]
    dev = have_dev.device
    i32 = dict(dtype=torch.int32, device=dev)
    plane_a, plane_b, need, need_cnt, sup_any = _k.slot_planes(
        have_dev, cand, owner_row, own_allowed, recv_ok, m_cnt,
        nonowner=nonowner, ungated=ungated)
    nbrc = nbr.clamp(min=0).long()
    valid_nbr = nbr >= 0
    live = valid_nbr & sup_any[nbrc]
    noise_base, tie_base, prio_base = (_u32(b.to(dev)) for b in bases)
    vidx = torch.arange(n, device=dev)
    rem_up = rem_up.to(torch.int32).clone()
    rem_down = rem_down.to(torch.int32).clone()
    recv_slots = torch.full((n,), tau, **i32)
    serving = torch.zeros_like(live)
    out_snd = torch.full((r_max, n), -1, **i32)
    out_col = torch.full((r_max, n, t_cap), -1, **i32)
    neg_inf = float("-inf")
    rounds = 0
    while rounds < r_max:
        r = rounds
        rounds += 1
        needy = (rem_down > 0) & (need_cnt > 0)
        feas = (live & valid_nbr & needy[:, None]
                & (rem_up[nbrc] > 0)
                & ((recv_slots[nbrc] > 0) | serving))
        noise = _salted(noise_base, r * 0x9E3779B9)
        if mode_id == 2:                 # GFF: fastest remaining uplink
            score = rem_up[nbrc].to(torch.float32) + noise
        else:
            score = noise
        score = torch.where(feas, score, neg_inf)

        if mode_id == 2:
            # One receiver per sender; losers re-pick among untaken
            # senders (the batched engine's masked retry loop).
            d_sel = torch.argmax(score, dim=1)
            act = feas.gather(1, d_sel[:, None])[:, 0]
            pair = torch.zeros(n, dtype=torch.bool, device=dev)
            d_v = torch.zeros(n, dtype=torch.int64, device=dev)
            taken = torch.zeros(n, **i32)
            for it in range(_GFF_RETRIES):
                salt = (it * 0xC2B2AE35) & 0xFFFFFFFF
                tie = _salted(tie_base, r * 0x85EBCA6B + salt)
                tie = torch.where(act, tie, -1.0)
                u_sel = nbrc[vidx, d_sel]
                wkey = torch.full((n,), -2.0, device=dev).scatter_reduce(
                    0, u_sel, tie, "amax", include_self=True)
                win = act & (tie >= 0.0) & (tie == wkey[u_sel])
                pair = pair | win
                d_v = torch.where(win, d_sel, d_v)
                taken = taken.scatter_reduce(0, u_sel, win.to(torch.int32),
                                             "amax", include_self=True)
                score = torch.where(taken[nbrc] > 0, neg_inf, score)
                act = act & ~win
                d_sel = torch.argmax(score, dim=1)
                best = score.gather(1, d_sel[:, None])[:, 0]
                act = act & torch.isfinite(best)
        else:
            # Sender multi-serve: every receiver keeps its chosen
            # sender; the grouped split below divides each uplink.
            d_v = torch.argmax(score, dim=1)
            best = score.gather(1, d_v[:, None])[:, 0]
            pair = torch.isfinite(best)

        u_v = torch.where(pair, nbrc[vidx, d_v], n)    # n = no pair
        u_c = u_v.clamp(max=n - 1)
        # Unpaired rows count garbage (clamped sender n-1); every
        # consumer below is masked on pair/take.
        sbc, cnt_b = _k.overlap_rank(plane_a, plane_b, need, u_c)
        cnt_a = torch.where(pair, sbc[:, -1], 0)
        cnt = cnt_a + torch.where(pair, cnt_b, 0)
        dead = pair & (cnt == 0)                      # tombstone
        live[vidx, d_v] = live[vidx, d_v] & ~dead

        req = torch.minimum(rem_down, cnt).clamp_(max=batch_cap)
        req = torch.where(pair, req, 0)
        # Mode-priority order within each sender group: fastest
        # downlink first for RFF, random arrival otherwise.
        pn = _salted(prio_base, r * 0x27D4EB2F)
        if mode_id == 1:
            recv_prio = -(rem_down.to(torch.float32) + pn)
        else:
            recv_prio = pn
        # lexsort((recv_prio, u_v)): two stable sorts; + 0.0 makes a
        # -0.0 priority +0.0, which the JAX comparator treats as equal
        order = torch.sort(recv_prio + 0.0, stable=True).indices
        order = order[torch.sort(u_v[order], stable=True).indices]
        us = u_v[order]
        us_c = us.clamp(max=n - 1)
        reqs = req[order].long()
        is_new = pair & ~serving[vidx, d_v]
        isn = is_new[order].long()
        first = torch.searchsorted(us, us)
        # tau gate: only the first recv_slots[u] NEW pairs of each
        # sender group may open a serve slot this round.
        cn = torch.cumsum(isn, 0)
        excl_new = cn - isn
        new_rank = excl_new - excl_new[first]
        reqs = torch.where((us < n) & ((isn == 0)
                                       | (new_rank < recv_slots[us_c])),
                           reqs, 0)
        # uplink split: grouped exclusive cumsum of requests caps each
        # pair at what its sender has left after earlier pairs.
        cq = torch.cumsum(reqs, 0)
        excl = cq - reqs
        take_s = torch.minimum(reqs, (rem_up[us_c]
                                      - (excl - excl[first])).clamp(min=0))
        take = torch.zeros(n, **i32)
        take[order] = take_s.to(torch.int32)
        granted = take > 0

        # Non-owner-first WITHIN each grant: fill from the non-owner
        # overlap, owner chunks only for the remainder (both tiers in
        # one extraction, so no host read decides whether to run the
        # owner tier).
        t_a = torch.minimum(take, cnt_a) if plane_b is not None else take
        cols = _k.extract_ranked(plane_a, plane_b, need, u_c, take, t_a,
                                 sbc, t_cap)

        need_cnt = need_cnt - take
        rem_down = rem_down - take
        rem_up.index_add_(0, u_c, torch.where(granted, -take, 0))
        fresh = granted & is_new
        serving[vidx, d_v] = serving[vidx, d_v] | fresh
        recv_slots.index_add_(0, u_c, -fresh.to(torch.int32))
        out_snd[r] = torch.where(granted, u_v.to(torch.int32), -1)
        out_col[r] = cols
        COUNTS["host_reads"] += 1
        if not bool(pair.any()):
            break
    COUNTS["rounds"] += rounds
    return out_snd, out_col, rounds


# ----------------------------------------------------------------------
# Host boundary: candidate prep, device dispatch, grant-grid decode
# ----------------------------------------------------------------------

def schedule_centralized_jit(state: SwarmState, mode: str):
    """One slot of the centralized family on the GPU slot engine."""
    cfg = state.cfg
    rng = state.rng
    n = cfg.n

    sactive = state.senders_active()
    rem_up = np.where(sactive, state.up, 0).astype(np.int32)
    rem_down = np.where(state.active, state.down, 0).astype(np.int32)

    cand = state.candidate_columns(sactive)
    if cand.size == 0:
        return _empty()
    # Same rarest-first priority draw as the batched engine, then one
    # seed draw for the noise bases: two draws per slot, always in this
    # order (the JAX package's rng discipline).
    prio = state.replicas[cand].astype(np.float32)
    prio += rng.random(cand.size, dtype=np.float32)
    cand = cand[np.argsort(prio)]
    seed = int(rng.integers(0, 2 ** 31 - 1))
    m = cand.size

    max_up = int(rem_up.max(initial=0))
    max_down = int(rem_down.max(initial=0))
    if max_up == 0 or max_down == 0:
        return _empty()
    warm = state.phase != "bt"
    recv_ok = state.active & (rem_down > 0)
    if warm:
        recv_ok = recv_ok & (state.hold < cfg.k_term)
    if not recv_ok.any():
        return _empty()

    # Static-shape buckets: the candidate count pads to a power of two
    # (floored near the universe size so small swarms reuse one shape).
    universe = state.have.shape[1]
    m_pad = max(_pow2(max(m, min(universe, 512))), 32)
    cand_p = np.zeros(m_pad, dtype=np.int32)
    cand_p[:m] = cand
    owner_p = np.zeros(m_pad, dtype=np.int32)
    owner_p[:m] = state.owners[cand]
    ungated = (not warm) or (not cfg.enable_gating)
    allowed_p = np.zeros(m_pad, dtype=bool)
    if not ungated:
        K = cfg.chunks_per_update
        kappa = cfg.owner_throttle
        _, starts, gated = state.owner_windows()
        co = state.owners[cand]
        off = cand - co * K
        allowed_p[:m] = (((off - starts[co]) % K) < kappa) & ~gated[co]
    nonowner_pass = bool(cfg.enable_nonowner_first) and warm

    # Warm-up grants carry the batched engine's fan-in cap (§IV-C: the
    # attack surface depends on receivers fanning in from ~all feasible
    # neighbors); BT batches stay budget-bound.
    batch_cap = max(max_up // 4, 1) if warm else _BIG
    t_cap = _pow2(min(batch_cap, max_down, max_up))
    r_max = min(_pow2(-(-max_down // min(batch_cap, max_down)) + 8), 64)

    _t0 = _clock()
    have_dev = _sync_have_dev(state)
    nbr_dev = _neighbor_lists(state)
    _t1 = _clock()
    dev = have_dev.device
    bases = _draw_bases(seed, n, nbr_dev.shape[1])
    out_snd, out_col, rounds = _slot_rounds(
        _MODE_IDS[mode], nonowner_pass, ungated, t_cap, r_max, have_dev,
        _upload(cand_p, dev), _upload(owner_p, dev),
        _upload(allowed_p, dev), m, _upload(recv_ok, dev), nbr_dev,
        _upload(rem_up, dev), _upload(rem_down, dev),
        min(batch_cap, _BIG), int(cfg.tau_concurrent), bases)
    # One read for both grids, of the rounds that ran.
    grids = torch.cat([out_snd[:rounds, :, None], out_col[:rounds]],
                      dim=2).cpu().numpy()
    COUNTS["host_reads"] += 1
    COUNTS["slots"] += 1
    out_snd = grids[:, :, 0]
    out_col = grids[:, :, 1:]
    _t2 = _clock()

    # Decode the grant grids in (round, receiver, pick) order: within a
    # grant picks are rarity-ordered with the non-owner tier first.
    r_i, v_i, k_i = np.nonzero(out_col >= 0)
    if r_i.size == 0:
        snd, rcv, chk = _empty()
    else:
        snd = out_snd[r_i, v_i].astype(np.int64)
        rcv = v_i.astype(np.int64)
        chk = cand[out_col[r_i, v_i, k_i]]
    _t3 = _clock()
    PHASE_S["bitplane_s"] += _t1 - _t0
    PHASE_S["matching_s"] += _t2 - _t1
    PHASE_S["extraction_s"] += _t3 - _t2
    return snd, rcv, chk

