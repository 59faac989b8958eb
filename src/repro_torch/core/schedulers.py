"""Warm-up chunk schedulers (paper §III-C) + vanilla-BT slot scheduling.

The family ships as :class:`~repro.core.policy.SchedulerPolicy` classes
registered under their paper names (``SwarmConfig.scheduler`` accepts a
name or an instance; see core/policy.py for the plugin API and
examples/custom_policy.py for a 20-line custom policy).  The policy
layer is a thin declaration of *what the mode may see*; the slot
*engines* below do the work and remain interchangeable backends behind
every policy (``SwarmConfig.scheduler_impl``).

Implements the paper's scheduler family:

* ``random_fifo``            — §III-C.3: random feasible sender, FIFO-ish
                               (random receiver processing order).
* ``random_fastest_first``   — §III-C.4: senders prioritize the fastest
                               requesters (receivers processed by
                               remaining downlink, senders random).
* ``greedy_fastest_first``   — §III-C.5: each request assigned to the
                               fastest feasible sender (max remaining
                               uplink); the paper's default.
* ``distributed``            — §III-C.6: clients only see the
                               neighborhood-level availability union
                               C^TA(v); requests may miss.
* ``flooding``               — §III-C.7: random push without receiver
                               state; wastes bandwidth.

All centralized schedulers apply the **non-owner-first** refinement
(§III-C): a sender that is not the chunk's original source is preferred;
the source is a fallback.  During warm-up, senders only serve chunks
from their *eligible* buffer (cover-set gating + owner throttling,
state.py), so every emitted transfer honors Eq. (1).

Budgets per slot: sender u uploads <= up[u] chunks to <= tau distinct
receivers; receiver v downloads <= down[v] chunks; duplicate deliveries
of a (receiver, chunk) pair are never scheduled.

Two slot-engine implementations are provided (``SwarmConfig
.scheduler_impl``):

* ``"batched"`` (default) — the paper-scale engine.  Per slot it builds
  the (sender x candidate-chunk) supply ONCE via the vectorized
  eligibility helpers in :class:`SwarmState` and resolves the
  assignment with budgeted rounds over ALL receivers at once: every
  round each needy receiver picks a feasible sender (mode-dependent
  score), senders grant rarest-first chunk batches under uplink /
  downlink / tau budgets, with non-owner-first applied inside every
  grant (non-owner overlap is extracted first, owner fallback fills
  the remainder — the loop engine's per-receiver pass structure).
* ``"loop"`` — the original per-receiver reference engine, kept
  byte-for-byte so equivalence tests can assert the batched engine
  schedules legally and matches its aggregate throughput.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .policy import (SchedulerPolicy, SlotView, VISIBILITY_FULL,
                     VISIBILITY_NEIGHBORHOOD, VISIBILITY_NONE,
                     get_policy, register_policy)
from .state import SwarmState

BIG = 1 << 40


def _empty():
    return (np.zeros(0, np.int64), np.zeros(0, np.int64),
            np.zeros(0, np.int64))


# Byte-prefix lookup for the bitpacked engine: _PREFIX[b, r] keeps only
# the first r set bits of byte b (MSB-first, matching np.packbits).
def _build_prefix() -> np.ndarray:
    bits = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1)
    csum = bits.cumsum(axis=1)
    out = np.zeros((256, 9), dtype=np.uint8)
    for r in range(9):
        out[:, r] = np.packbits(bits & (csum <= r), axis=1)[:, 0]
    return out


_PREFIX = _build_prefix()

_BLK = 32          # bytes per extraction block; plane widths pad to this


def _pad_cols(a: np.ndarray, pad: int) -> np.ndarray:
    """Zero-pad packed planes on the right (np.pad's overhead hurts in
    the per-slot path)."""
    out = np.zeros((a.shape[0], a.shape[1] + pad), dtype=a.dtype)
    out[:, :a.shape[1]] = a
    return out


def _count_rows(rows_p: np.ndarray):
    """Block-level popcount cumsum of packed rows.

    Returns ``(bcum, cnt)``: (G, nblk) cumulative set-bit counts per
    _BLK-byte block and the (G,) row totals.  Avoids a full byte-wise
    cumsum over the plane width — only each grant's single boundary
    block is later refined byte-by-byte in :func:`_extract_prefix`.
    """
    g, mb = rows_p.shape
    nblk = mb // _BLK
    if nblk == 0:
        return np.zeros((g, 0), np.int64), np.zeros(g, np.int64)
    w64 = np.bitwise_count(rows_p.view(np.uint64))
    bcnt = w64.reshape(g, nblk, _BLK // 8) @ np.ones(_BLK // 8, np.int64)
    bcum = np.cumsum(bcnt, axis=1)
    return bcum, bcum[:, -1]


def _extract_prefix(rows_p: np.ndarray, bcum: np.ndarray,
                    take: np.ndarray):
    """Keep only the first ``take[i]`` set bits of each packed row.

    Hierarchical: whole blocks below the boundary are copied, the
    boundary block gets a byte-wise cumsum, and its boundary byte is
    trimmed with the _PREFIX lookup.  Returns ``(sel_p, gi, ci)`` where
    (gi, ci) are the selected (row, bit-column) pairs in row-major
    (i.e. rarest-first) order.
    """
    g, mb = rows_p.shape
    nblk = mb // _BLK
    fullb = bcum <= take[:, None]
    blk = fullb.sum(axis=1)
    sel_p = np.where(np.repeat(fullb, _BLK, axis=1), rows_p, np.uint8(0))
    # Every step below is empty-safe, so the boundary-block refinement
    # and the decode run unconditionally (jit-clean: no `if arr.size`
    # branches on array values).
    gb = np.flatnonzero(blk < nblk)
    blkb = blk[gb]
    prevb = np.where(
        blkb > 0,
        np.take_along_axis(bcum[gb], np.maximum(blkb - 1, 0)[:, None],
                           axis=1)[:, 0], 0)
    rblk = take[gb] - prevb                 # bits wanted in boundary
    bb = np.take_along_axis(rows_p[gb].reshape(gb.size, nblk, _BLK),
                            blkb[:, None, None], axis=1)[:, 0]
    wcum = np.cumsum(np.bitwise_count(bb), axis=1, dtype=np.int16)
    fullw = wcum <= rblk[:, None]
    selb = np.where(fullw, bb, np.uint8(0))
    cut = fullw.sum(axis=1)
    g2 = np.flatnonzero(cut < _BLK)
    cb = cut[g2]
    prev = np.where(cb > 0, wcum[g2, np.maximum(cb - 1, 0)], 0)
    r = np.minimum(rblk[g2] - prev, 8)
    selb[g2, cb] = _PREFIX[bb[g2, cb], r]
    sel_p.reshape(g, nblk, _BLK)[gb, blkb] = selb
    # Decode: uint64 words -> set bytes -> set bits, scanning only the
    # packed plane and then only its populated pieces.
    w64 = sel_p.view(np.uint64)
    g64, i64 = np.nonzero(w64)
    b8 = sel_p.reshape(g, mb // 8, 8)[g64, i64]     # (H, 8) bytes
    hz, bz = np.nonzero(b8)
    vals = b8[hz, bz]
    bits = np.unpackbits(vals[:, None], axis=1).view(bool)
    gi8 = np.broadcast_to(g64[hz][:, None], (hz.size, 8))
    ci8 = (i64[hz] * 8 + bz)[:, None] * 8 + np.arange(8)
    return sel_p, gi8[bits], ci8[bits]


# ----------------------------------------------------------------------
# Supply-restricted candidate columns (loop-engine legacy helpers;
# max-flow and the batched engine use the vectorized SwarmState API)
# ----------------------------------------------------------------------

def _candidate_columns(state: SwarmState, sactive: np.ndarray) -> np.ndarray:
    """Chunk ids that at least one sender could serve this slot."""
    cfg = state.cfg
    if state.phase == "bt" or not cfg.enable_gating:
        # Everything any active client holds is eligible; cheapest
        # over-approximation is "all chunks" (every chunk has an owner).
        return np.arange(cfg.total_chunks)
    mask = state.replicas > 1          # replicated => some non-owner holds it
    for u in np.flatnonzero(sactive):
        win = state.eligible_owner_slice(int(u))
        if win.size:
            mask[win] = True
    cand = np.flatnonzero(mask)
    cap = cfg.cand_cap
    if cap and cand.size > cap:
        # Rarity-stratified cap, mirroring SwarmState.candidate_columns:
        # the rarest cap/2 plus an even stride over the rest, so large
        # swarms keep servable supply in every neighborhood.
        half = cap // 2
        sel = np.argpartition(state.replicas[cand], half - 1)[:half]
        covered = np.zeros(cand.size, dtype=bool)
        covered[sel] = True
        rest = np.flatnonzero(~covered)
        take = cap - half
        pos = (np.arange(take, dtype=np.int64) * rest.size) // max(take, 1)
        cand = np.sort(cand[np.concatenate([sel, rest[pos]])])
    return cand


def _supply_matrix(state: SwarmState, nbr_idx: np.ndarray,
                   cand: np.ndarray, cand_owner: np.ndarray) -> np.ndarray:
    """(len(nbrs), len(cand)) bool: can neighbor j serve candidate chunk?"""
    sup = state.have[np.ix_(nbr_idx, cand)]
    if state.phase != "bt" and state.cfg.enable_gating:
        for j, u in enumerate(nbr_idx):
            own = cand_owner == u
            if not own.any():
                continue
            win = state.eligible_owner_slice(int(u))
            allowed = np.isin(cand, win, assume_unique=True)
            sup[j] &= (~own) | allowed
    return sup


# ----------------------------------------------------------------------
# Centralized scheduler family — loop (reference) engine
# ----------------------------------------------------------------------

def _schedule_centralized_loop(state: SwarmState, mode: str):
    """One stage of tracker-assigned transfers.  Returns (snd, rcv, chk)."""
    cfg = state.cfg
    rng = state.rng
    n = cfg.n

    sactive = state.senders_active()
    rem_up = np.where(sactive, state.up, 0).astype(np.int64)
    rem_down = np.where(state.active, state.down, 0).astype(np.int64)
    recv_slots = np.full(n, cfg.tau_concurrent, dtype=np.int64)
    serving = np.zeros((n, n), dtype=bool)   # sender already serving recv

    cand = _candidate_columns(state, sactive)
    if cand.size == 0:
        return _empty()
    cand_owner = state.owners[cand]
    # Rarest-first priority with random tie-break (recomputed per slot).
    prio = state.replicas[cand].astype(np.float64)
    prio += rng.random(cand.size)

    if mode == "random_fastest_first":
        # sender-side "tau fastest requesters": fast receivers get
        # first claim on the per-sender serving slots
        recv_order = np.argsort(-(rem_down + rng.random(n)))
    else:
        # request arrival order is random; GFF greediness lives in
        # the per-request fastest-SENDER assignment below
        recv_order = rng.permutation(n)

    out_s, out_r, out_c = [], [], []

    warm = state.phase != "bt"
    for v in recv_order:
        v = int(v)
        if rem_down[v] <= 0 or not state.active[v]:
            continue
        # Warm-up serves only clients still below the cover-set
        # threshold (§III-B: "until all active clients reach the k-chunk
        # threshold"); satisfied clients stop issuing warm-up requests.
        if warm and state.hold[v] >= cfg.k_term:
            continue
        nbr_mask = state.adj[v] & (rem_up > 0) & (recv_slots > 0)
        nbr_mask |= state.adj[v] & (rem_up > 0) & serving[:, v]
        nbr_idx = np.flatnonzero(nbr_mask)
        if nbr_idx.size == 0:
            continue

        sup = _supply_matrix(state, nbr_idx, cand, cand_owner)
        need_v = ~state.have[v, cand]
        sup &= need_v[None, :]
        if not sup.any():
            continue

        taken = np.zeros(cand.size, dtype=bool)
        budget = int(rem_down[v])
        # pass 0: non-owner-first; pass 1: owner fallback
        passes = (0, 1) if cfg.enable_nonowner_first else (1,)
        if mode == "greedy_fastest_first":
            # Per-REQUEST assignment (§III-C.5): every missing chunk goes
            # to the currently-fastest feasible sender; rem_up decrements
            # re-rank senders between requests, spreading load instead of
            # letting one receiver drain the fastest sender's uplink+tau.
            # Per-sender rarest-first queues with lazy deletion keep each
            # request O(log)-ish instead of rescanning all candidates.
            queues = []
            qcap = max(4 * int(rem_down[v]) + 8, 64)
            for jj in range(nbr_idx.size):
                ids = np.flatnonzero(sup[jj])
                if ids.size > qcap:   # only ever need ~rem_down picks
                    sel = np.argpartition(prio[ids], qcap - 1)[:qcap]
                    ids = ids[sel]
                queues.append(ids[np.argsort(prio[ids])])
            ptr = np.zeros(nbr_idx.size, dtype=np.int64)
            deferred: list = [[] for _ in range(nbr_idx.size)]
            for pass_id in passes:
                while budget > 0:
                    feas = (rem_up[nbr_idx] > 0) & (
                        (recv_slots[nbr_idx] > 0) | serving[nbr_idx, v])
                    if not feas.any():
                        break
                    jidx = np.flatnonzero(feas)
                    jorder = jidx[np.argsort(-(rem_up[nbr_idx[jidx]]
                                               + rng.random(jidx.size)))]
                    progressed = False
                    for jj in jorder:
                        if budget <= 0:
                            break
                        u = int(nbr_idx[jj])
                        q = queues[jj]
                        p = int(ptr[jj])
                        pick = -1
                        if pass_id != 0:     # owner chunks deferred first
                            while deferred[jj]:
                                c = deferred[jj].pop(0)
                                if not taken[c]:
                                    pick = c
                                    break
                        while pick < 0 and p < len(q):
                            c = int(q[p])
                            p += 1
                            if taken[c]:
                                continue
                            if pass_id == 0 and cand_owner[c] == u:
                                deferred[jj].append(c)  # wait for pass 1
                                continue
                            pick = c
                        ptr[jj] = p
                        if pick < 0:
                            continue
                        taken[pick] = True
                        rem_up[u] -= 1
                        budget -= 1
                        if not serving[u, v]:
                            serving[u, v] = True
                            recv_slots[u] -= 1
                        out_s.append(np.full(1, u, dtype=np.int64))
                        out_r.append(np.full(1, v, dtype=np.int64))
                        out_c.append(cand[pick:pick + 1])
                        progressed = True
                    if not progressed:
                        break
        else:
            sender_order = rng.permutation(nbr_idx.size)
            for pass_id in passes:
                if budget <= 0:
                    break
                for jj in sender_order:
                    if budget <= 0:
                        break
                    u = int(nbr_idx[jj])
                    cap = int(rem_up[u])
                    if cap <= 0:
                        continue
                    if recv_slots[u] <= 0 and not serving[u, v]:
                        continue
                    row = sup[jj] & ~taken
                    if pass_id == 0:
                        row = row & (cand_owner != u)
                    ids = np.flatnonzero(row)
                    if ids.size == 0:
                        continue
                    take_n = min(cap, budget, ids.size)
                    if take_n < ids.size:
                        sel = np.argpartition(prio[ids],
                                              take_n - 1)[:take_n]
                        ids = ids[sel]
                    taken[ids] = True
                    rem_up[u] -= len(ids)
                    budget -= len(ids)
                    if not serving[u, v]:
                        serving[u, v] = True
                        recv_slots[u] -= 1
                    out_s.append(np.full(len(ids), u, dtype=np.int64))
                    out_r.append(np.full(len(ids), v, dtype=np.int64))
                    out_c.append(cand[ids])
        rem_down[v] = budget

    if not out_s:
        return _empty()
    return (np.concatenate(out_s), np.concatenate(out_r),
            np.concatenate(out_c))


# ----------------------------------------------------------------------
# Centralized scheduler family — batched (paper-scale) engine
# ----------------------------------------------------------------------

def _schedule_centralized_batched(state: SwarmState, mode: str):
    """Vectorized budgeted-round slot assignment over all receivers.

    Per slot: candidate columns and the full (sender x candidate)
    eligible supply are built ONCE via the vectorized SwarmState
    helpers, and columns are pre-sorted by rarest-first priority so the
    first set bits of any supply&need row are the rarest feasible picks.

    Assignment then proceeds in fully vectorized budgeted rounds.  Each
    round every needy receiver selects one feasible sender (fastest
    remaining uplink for GFF, random otherwise) among neighbors with a
    known serveable overlap (an edge-wise popcount prior computed once
    per slot).  For the random modes each sender then splits its uplink
    over all its requesters in mode-priority order (fastest-downlink
    first for RandomFastestFirst) via grouped exclusive cumsums; for
    GFF one receiver wins each sender (it may drain the fastest sender,
    as loop-GFF receivers do) and losers re-pick among untaken senders.
    All (sender, receiver) grants extract their rarest-first chunk
    batches in one shot through the hierarchical block/byte/bit
    popcount machinery (:func:`_count_rows` / :func:`_extract_prefix`)
    — no per-transfer Python.  Batches are bounded by remaining
    uplink/downlink and the tau concurrency slots.  Non-owner-first
    runs as a masked first pass during warm-up; pairs whose overlap was
    consumed mid-slot are tombstoned so rounds terminate after at most
    O(degree) retries per receiver.
    """
    cfg = state.cfg
    rng = state.rng
    n = cfg.n

    sactive = state.senders_active()
    rem_up = np.where(sactive, state.up, 0).astype(np.int64)
    rem_down = np.where(state.active, state.down, 0).astype(np.int64)
    recv_slots = np.full(n, cfg.tau_concurrent, dtype=np.int64)
    serving = np.zeros((n, n), dtype=bool)    # (receiver, sender)

    cand = state.candidate_columns(sactive)
    if cand.size == 0:
        return _empty()
    # float32 keeps the jitter resolving ties without flipping distinct
    # replica counts (< 2^23 in any feasible swarm) and sorts faster.
    prio = state.replicas[cand].astype(np.float32)
    prio += rng.random(cand.size, dtype=np.float32)
    cand = cand[np.argsort(prio)]              # columns in rarity order
    m = cand.size

    # Bitpacked (n, ceil(m/8)) supply and need planes, built ONCE per
    # slot from a single priority-ordered gather of ``have``; all round
    # bookkeeping below runs in the packed domain so per-round work is
    # ~m/8 bytes per touched row.  np.take keeps the gather result
    # C-contiguous (a fancy ``have[:, cand]`` yields a transposed view
    # that makes every downstream byte op ~25x slower).
    hv = np.take(state.have, cand, axis=1)
    sup_p = np.packbits(state.eligible_supply(cand, have_cols=hv), axis=1)
    warm = state.phase != "bt"
    recv_ok = state.active & (rem_down > 0)
    if warm:
        recv_ok &= state.hold < cfg.k_term
    need_p = np.packbits(~hv, axis=1)
    pad = (-need_p.shape[1]) % _BLK            # block-align the planes
    if pad:
        sup_p = _pad_cols(sup_p, pad)
        need_p = _pad_cols(need_p, pad)
    need_p[~recv_ok] = 0                       # row mask, packed domain
    need_cnt = np.bitwise_count(
        need_p.view(np.uint64)).sum(axis=1).astype(np.int64)

    # Non-owner-first is a warm-up privacy refinement (§III-C): during
    # BT swarming transfers are not attack-observed and the ungated
    # supply is dense, so the preference is aggregate-neutral there and
    # BT grants extract single-tier.
    nonowner_pass = cfg.enable_nonowner_first and warm
    if nonowner_pass:
        # Per-sender packed mask of NON-owned candidate columns, built
        # once per slot directly in the packed domain: each column has
        # exactly one owner row, so clearing m bits in an all-ones
        # plane beats materializing the dense (n, m) complement (~25x
        # at the n=500/K=206 point).  Pad bytes stay 0xFF, which is
        # harmless: every use ANDs against rows whose pad bits are 0.
        cand_owner = state.owners[cand]
        cols = np.arange(m)
        nonown_p = np.full((n, need_p.shape[1]), 255, dtype=np.uint8)
        np.bitwise_and.at(nonown_p, (cand_owner, cols >> 3),
                          (255 ^ (128 >> (cols & 7))).astype(np.uint8))

    if not need_cnt.any():
        return _empty()

    # Warm-up grants are capped to a fraction of the fastest uplink so
    # every receiver fans in from ~all feasible neighbors within a slot,
    # matching the loop engine's per-request spreading — the attack
    # surface (§IV-C reads warm-up logs) depends on that fan-in: a
    # receiver served by only a handful of full-drain senders would see
    # first-contact chunk mixes the paper's ablation ASR curves never
    # see.  BT batches stay budget-bound (attacks never read them).
    if warm:
        # np scalar end to end: no host coercion (device->host sync
        # under a jitted build), same value in every integer op below.
        batch_cap = np.maximum(np.max(rem_up, initial=0) // 4, 1)
    else:
        batch_cap = BIG

    out_s, out_r, out_c = [], [], []

    # live (receiver, sender) pairs: sender-supply prior minus
    # mid-slot tombstones.  During warm-up most senders are still
    # gated with nothing serveable, so the receiver-independent
    # mask removes almost all blind retries; the rare empty pair is
    # tombstoned when its grant comes back empty.
    live = state.adj & sup_p.any(axis=1)[None, :]
    while True:
        ridx = np.flatnonzero((rem_down > 0) & (need_cnt > 0))
        if ridx.size == 0:
            break
        # Feasible sender matrix for the needy receivers (R, n).
        feas = (live[ridx]
                & (rem_up > 0)[None, :]
                & ((recv_slots > 0)[None, :] | serving[ridx]))
        if mode == "greedy_fastest_first":
            score = rem_up.astype(np.float32)[None, :] \
                + rng.random((ridx.size, n), dtype=np.float32)
        else:
            score = rng.random((ridx.size, n), dtype=np.float32)
        score = np.where(feas, score, -np.inf)
        choice = np.argmax(score, axis=1)
        has = feas[np.arange(ridx.size), choice]
        ridx, choice, score = ridx[has], choice[has], score[has]
        if ridx.size == 0:
            break
        # --- pair selection ---
        if mode == "greedy_fastest_first":
            # One receiver per sender (the winner may drain the
            # fastest sender, as loop-GFF receivers do); losing
            # receivers re-pick among still-untaken senders a few
            # times so one round builds a near-maximal matching.
            u_parts, v_parts = [], []
            pos = np.arange(ridx.size)
            cur = choice
            for _ in range(3):
                order = rng.permutation(pos.size)
                _, first = np.unique(cur[order], return_index=True)
                winpos = order[first]
                u_parts.append(cur[winpos])
                v_parts.append(ridx[pos[winpos]])
                score[:, cur[winpos]] = -np.inf
                lose = np.ones(pos.size, dtype=bool)
                lose[winpos] = False
                pos, cur = pos[lose], None
                if pos.size == 0:
                    break
                cur = np.argmax(score[pos], axis=1)
                ok = score[pos, cur] > -np.inf
                pos, cur = pos[ok], cur[ok]
                if pos.size == 0:
                    break
            u_a = np.concatenate(u_parts)
            v_a = np.concatenate(v_parts)
            po = np.argsort(u_a, kind="stable")
            u_a, v_a = u_a[po], v_a[po]
        else:
            # Sender multi-serve: every receiver keeps its chosen
            # sender; each sender splits its uplink over its
            # requesters in mode-priority order.
            if mode == "random_fastest_first":
                order = np.argsort(-(rem_down[ridx]
                                     + rng.random(ridx.size)))
            else:
                order = rng.permutation(ridx.size)
            po = order[np.argsort(choice[order], kind="stable")]
            u_a, v_a = choice[po], ridx[po]

        # Rarest-first batch extraction for all grants at once, in
        # the packed domain: byte-popcount cumsum locates each
        # grant's boundary byte; _PREFIX trims it to the exact
        # batch size; one unpack+nonzero yields all chunk picks.
        rows_p = sup_p[u_a] & need_p[v_a]
        bcum, cnt = _count_rows(rows_p)
        empty_pair = cnt == 0
        if empty_pair.any():
            live[v_a[empty_pair], u_a[empty_pair]] = False
        req = np.minimum(np.minimum(rem_down[v_a], cnt), batch_cap)
        # tau gate: within each sender group (u_a is sorted) only
        # the first recv_slots[u] NEW pairs may open a serve slot.
        first_pos = np.searchsorted(u_a, u_a)
        is_new = ~serving[v_a, u_a]
        cn = np.cumsum(is_new)
        excl_new = cn - is_new
        new_rank = excl_new - excl_new[first_pos]
        req = np.where(~is_new | (new_rank < recv_slots[u_a]), req, 0)
        # uplink split: grouped exclusive cumsum of requests caps
        # each pair at what its sender has left after earlier pairs.
        cq = np.cumsum(req)
        excl = cq - req
        take = np.minimum(req, np.maximum(
            rem_up[u_a] - (excl - excl[first_pos]), 0))
        granted = take > 0
        if not granted.any():
            continue                       # tombstones grew; retry
        u_g, v_g, take_g = u_a[granted], v_a[granted], take[granted]
        rows_g = rows_p[granted]
        bcum_g = bcum[granted]
        if nonowner_pass:
            # Non-owner-first WITHIN each grant (the loop engine's
            # per-receiver pass structure): fill from the non-owner
            # part of the overlap first, fall back to the sender's
            # own chunks only for the remainder of this grant.
            rows_no = rows_g & nonown_p[u_g]
            bcum_no, cnt_no = _count_rows(rows_no)
            take_no = np.minimum(take_g, cnt_no)
            sel_no, gi0, ci0 = _extract_prefix(rows_no, bcum_no,
                                               take_no)
            rows_ow = rows_g & ~nonown_p[u_g]
            take_ow = take_g - take_no
            sel_ow, gi1, ci1 = _extract_prefix(
                rows_ow, bcum_g - bcum_no, take_ow)
            sel_p = sel_no | sel_ow
            # non-owner picks are appended first so each (v, u)
            # pair's earliest logged chunk mirrors the loop order
            out_s.append(u_g[gi0])
            out_r.append(v_g[gi0])
            out_c.append(cand[ci0])
            out_s.append(u_g[gi1])
            out_r.append(v_g[gi1])
            out_c.append(cand[ci1])
        else:
            sel_p, gi, ci = _extract_prefix(rows_g, bcum_g, take_g)
            out_s.append(u_g[gi])
            out_r.append(v_g[gi])
            out_c.append(cand[ci])
        need_p[v_g] &= ~sel_p
        need_cnt[v_g] -= take_g
        np.subtract.at(rem_up, u_g, take_g)
        rem_down[v_g] -= take_g
        fresh = is_new[granted]
        if fresh.any():
            serving[v_g[fresh], u_g[fresh]] = True
            np.subtract.at(recv_slots, u_g[fresh], 1)

    if not out_s:
        return _empty()
    return (np.concatenate(out_s), np.concatenate(out_r),
            np.concatenate(out_c))


# ----------------------------------------------------------------------
# Distributed scheduling (neighborhood-level announcements, §III-C.6)
# ----------------------------------------------------------------------

def _schedule_distributed_loop(state: SwarmState):
    """Clients request random missing chunks from random neighbors.

    The tracker only publishes the neighborhood union C^TA(v, s), so a
    request may land on a neighbor that cannot serve it (wasted).
    """
    cfg = state.cfg
    rng = state.rng
    n = cfg.n
    sactive = state.senders_active()
    rem_up = np.where(sactive, state.up, 0).astype(np.int64)
    rem_down = np.where(state.active, state.down, 0).astype(np.int64)

    cand = _candidate_columns(state, sactive)
    if cand.size == 0:
        return _empty()
    cand_owner = state.owners[cand]

    warm = state.phase != "bt"
    req_s, req_r, req_c = [], [], []
    for v in range(n):
        v = int(v)
        if rem_down[v] <= 0 or not state.active[v]:
            continue
        if warm and state.hold[v] >= cfg.k_term:
            continue
        nbr_idx = np.flatnonzero(state.adj[v])
        if nbr_idx.size == 0:
            continue
        # Neighborhood-level availability: union over neighbors, no map.
        sup = _supply_matrix(state, nbr_idx, cand, cand_owner)
        union = sup.any(axis=0) & ~state.have[v, cand]
        ids = np.flatnonzero(union)
        if ids.size == 0:
            continue
        want = min(int(rem_down[v]), ids.size)
        pick = rng.choice(ids, size=want, replace=False)
        # Random neighbor per request (client cannot target the holder).
        tgt = rng.choice(nbr_idx, size=want, replace=True)
        ok = sup[np.searchsorted(nbr_idx, tgt), pick]  # request hit?
        req_s.append(tgt[ok])
        req_r.append(np.full(int(ok.sum()), v, dtype=np.int64))
        req_c.append(cand[pick[ok]])

    if not req_s:
        return _empty()
    snd = np.concatenate(req_s)
    rcv = np.concatenate(req_r)
    chk = np.concatenate(req_c)
    # Senders serve FIFO up to their uplink budget.
    order = rng.permutation(len(snd))
    snd, rcv, chk = snd[order], rcv[order], chk[order]
    keep = np.zeros(len(snd), dtype=bool)
    for i in range(len(snd)):
        u = snd[i]
        if rem_up[u] > 0:
            keep[i] = True
            rem_up[u] -= 1
    return snd[keep], rcv[keep], chk[keep]


def _schedule_distributed_batched(state: SwarmState):
    """Batched distributed mode: one supply build, vectorized requests.

    The eligible supply is built once; the per-receiver neighborhood
    union is accumulated sender-major (each sender ORs its row into its
    neighbors), request chunks are drawn per receiver via random-score
    top-k over the union, targets are uniform random neighbors, and the
    sender-side FIFO uplink trim is resolved with a stable grouped rank
    instead of a per-request Python loop.
    """
    cfg = state.cfg
    rng = state.rng
    n = cfg.n
    sactive = state.senders_active()
    rem_up = np.where(sactive, state.up, 0).astype(np.int64)
    rem_down = np.where(state.active, state.down, 0).astype(np.int64)

    cand = state.candidate_columns(sactive)
    if cand.size == 0:
        return _empty()
    m = cand.size

    sup = state.eligible_supply(cand)          # (n, m), built once
    warm = state.phase != "bt"
    recv_ok = state.active & (rem_down > 0)
    if warm:
        recv_ok &= state.hold < cfg.k_term
    deg = state.adj.sum(axis=1)
    recv_ok &= deg > 0

    # Neighborhood availability union, sender-major accumulation.
    union = np.zeros((n, m), dtype=bool)
    for u in range(n):
        row = sup[u]
        if row.any():
            union[state.adj[u]] |= row[None, :]
    union &= ~state.have[:, cand]
    union &= recv_ok[:, None]

    ridx = np.flatnonzero(union.any(axis=1))
    if ridx.size == 0:
        return _empty()
    avail = union[ridx]
    counts = avail.sum(axis=1)
    want = np.minimum(rem_down[ridx], counts).astype(np.int64)

    # Distinct random picks per receiver: random scores, row-wise sort,
    # take the first want[i] columns of each row.
    scores = np.where(avail, rng.random((ridx.size, m)), np.inf)
    order = np.argsort(scores, axis=1)
    take_mask = np.arange(m)[None, :] < want[:, None]
    rows = np.repeat(np.arange(ridx.size), want)
    cols = order[take_mask]
    rcv = ridx[rows]
    chk = cand[cols]

    # Uniform random neighbor per request via padded neighbor lists.
    nz_r, nz_c = np.nonzero(state.adj)
    starts = np.searchsorted(nz_r, np.arange(n))
    pick = (rng.random(len(rcv)) * deg[rcv]).astype(np.int64)
    snd = nz_c[starts[rcv] + pick]
    hit = sup[snd, cols]                       # request hit the holder?
    snd, rcv, chk = snd[hit], rcv[hit], chk[hit]
    if len(snd) == 0:
        return _empty()

    # FIFO uplink trim: random arrival order, then rank within each
    # sender group (stable sort preserves arrival order).
    arrival = rng.permutation(len(snd))
    snd, rcv, chk = snd[arrival], rcv[arrival], chk[arrival]
    grp = np.argsort(snd, kind="stable")
    ss = snd[grp]
    first = np.searchsorted(ss, ss)            # start index of own group
    rank = np.arange(len(ss)) - first
    keep_sorted = rank < rem_up[ss]
    keep = np.zeros(len(snd), dtype=bool)
    keep[grp] = keep_sorted
    return snd[keep], rcv[keep], chk[keep]


# ----------------------------------------------------------------------
# Flooding (§III-C.7) — shared by both engines (stateful pair memory)
# ----------------------------------------------------------------------

@dataclass
class FloodRoundState:
    """Typed per-round flooding memory, owned by the policy instance.

    ``sent`` maps the directed pair (sender, receiver) to the set of
    chunk ids already pushed over it; flooding never repeats a push, but
    receivers may already hold the chunk (wasted bandwidth), which is
    exactly why flooding under-performs coordinated warm-up (§III-C).
    """

    sent: dict = field(default_factory=dict)   # (u, v) -> set[int]

    def seen(self, u: int, v: int) -> set:
        return self.sent.setdefault((u, v), set())


def schedule_flooding(state: SwarmState, sent_pairs: dict):
    """Push random eligible chunks to random neighbors, no repetition.

    ``sent_pairs`` is the :class:`FloodRoundState` pair memory (legacy
    callers may still pass the raw dict it wraps).
    """
    if isinstance(sent_pairs, FloodRoundState):
        sent_pairs = sent_pairs.sent
    cfg = state.cfg
    rng = state.rng
    n = cfg.n
    sactive = state.senders_active()
    rem_down = np.where(state.active, state.down, 0).astype(np.int64)

    out_s, out_r, out_c = [], [], []
    for u in np.flatnonzero(sactive):
        u = int(u)
        budget = int(state.up[u])
        elig = np.flatnonzero(state.eligible_row(u))
        nbr_idx = np.flatnonzero(state.adj[u] & state.active)
        if elig.size == 0 or nbr_idx.size == 0:
            continue
        tgts = rng.choice(nbr_idx, size=budget, replace=True)
        picks = rng.choice(elig, size=budget, replace=True)
        for t, c in zip(tgts, picks):
            key = (u, int(t))
            seen = sent_pairs.setdefault(key, set())
            if int(c) in seen or rem_down[t] <= 0:
                continue
            seen.add(int(c))
            rem_down[t] -= 1
            out_s.append(u)
            out_r.append(int(t))
            out_c.append(int(c))
    if not out_s:
        return _empty()
    return (np.asarray(out_s, np.int64), np.asarray(out_r, np.int64),
            np.asarray(out_c, np.int64))


# ----------------------------------------------------------------------
# Policy classes: the §III-C family on the SchedulerPolicy protocol.
# Both slot engines stay interchangeable backends behind each policy
# (``SwarmConfig.scheduler_impl``); schedules are byte-identical to the
# historical string dispatch (tests/golden_schedules.json).
# ----------------------------------------------------------------------

CENTRALIZED = {"random_fifo", "random_fastest_first", "greedy_fastest_first"}


def _impl(state: SwarmState) -> str:
    impl = getattr(state.cfg, "scheduler_impl", "batched")
    if impl not in ("batched", "loop", "jit"):
        raise ValueError(f"unknown scheduler_impl {impl!r}")
    return impl


class CentralizedPolicy(SchedulerPolicy):
    """Tracker-assigned modes (§III-C.3-5): full supply-matrix view."""

    visibility = VISIBILITY_FULL
    mode: str = ""

    def schedule(self, view: SlotView):
        state = view._engine_state()
        impl = _impl(state)
        if impl == "loop":
            return _schedule_centralized_loop(state, self.mode)
        if impl == "jit":
            from .jit_engine import schedule_centralized_jit
            return schedule_centralized_jit(state, self.mode)
        return _schedule_centralized_batched(state, self.mode)


@register_policy
class RandomFIFOPolicy(CentralizedPolicy):
    """§III-C.3: random feasible sender, random receiver order."""

    name = mode = "random_fifo"


@register_policy
class RandomFastestFirstPolicy(CentralizedPolicy):
    """§III-C.4: senders prioritize the fastest requesters."""

    name = mode = "random_fastest_first"


@register_policy
class GreedyFastestFirstPolicy(CentralizedPolicy):
    """§III-C.5: each request to the fastest feasible sender (paper
    default)."""

    name = mode = "greedy_fastest_first"


@register_policy
class VanillaBTPolicy(CentralizedPolicy):
    """Vanilla BitTorrent swarming slot (§III-A step 4): ungated
    rarest-first with random feasible senders — the BT-phase backend
    behind :func:`repro.core.bittorrent.bt_exact_slot`."""

    name = "bt_vanilla"
    mode = "random_fifo"
    phases = ("bt",)


@register_policy
class DistributedPolicy(SchedulerPolicy):
    """§III-C.6: clients see only the neighborhood availability union
    C^T A(v); requests target random neighbors and may miss."""

    name = "distributed"
    visibility = VISIBILITY_NEIGHBORHOOD

    def schedule(self, view: SlotView):
        state = view._engine_state()
        # "jit" routes to the batched backend here: the distributed
        # mode's hot path is already one-shot vectorized (no budgeted
        # round loop to stage), so a separate kernel would buy nothing.
        if _impl(state) == "loop":
            return _schedule_distributed_loop(state)
        return _schedule_distributed_batched(state)


@register_policy
class FloodingPolicy(SchedulerPolicy):
    """§III-C.7: random push without receiver state; the per-round pair
    memory is typed policy-owned state, reset every round."""

    name = "flooding"
    visibility = VISIBILITY_NONE

    def __init__(self):
        self.round_state = FloodRoundState()

    def reset(self, cfg) -> None:
        self.round_state = FloodRoundState()

    def schedule(self, view: SlotView):
        return schedule_flooding(view._engine_state(), self.round_state)


# ----------------------------------------------------------------------
# Legacy entry points (pre-policy API), kept for external callers
# ----------------------------------------------------------------------

def schedule_centralized(state: SwarmState, mode: str):
    impl = _impl(state)
    if impl == "loop":
        return _schedule_centralized_loop(state, mode)
    if impl == "jit":
        from .jit_engine import schedule_centralized_jit
        return schedule_centralized_jit(state, mode)
    return _schedule_centralized_batched(state, mode)


def schedule_distributed(state: SwarmState):
    if _impl(state) == "loop":
        return _schedule_distributed_loop(state)
    return _schedule_distributed_batched(state)


def run_scheduler(state: SwarmState, flood_state: dict | None = None):
    """One slot of ``state.cfg.scheduler`` via the policy registry.

    Shim for the historical string-dispatch signature: resolves the
    configured policy and schedules a single slot.  ``flood_state`` (a
    raw pair-memory dict) is honored for flooding so old callers keep
    their cross-slot no-repeat semantics; policy-native callers use
    :class:`FloodingPolicy`'s own round state instead.
    """
    pol = get_policy(state.cfg.scheduler)
    if isinstance(pol, FloodingPolicy):
        # The shim builds a fresh policy per call, so a legacy caller
        # MUST thread the pair memory or the cross-slot no-repeat
        # invariant silently breaks (the historical contract).
        assert flood_state is not None, \
            "flooding via run_scheduler() needs a caller-held flood_state"
        pol.round_state = FloodRoundState(sent=flood_state)
    return pol.schedule(SlotView(state, pol.visibility))
