"""Bitplane kernels of the GPU slot engine (``core/jit_engine.py``).

The JAX package computes a slot as plain ``lax`` code over packed
uint32 words (``repro/core/jit_engine.py::_slot_rounds``): no TPU kernel
is behind any of it.  torch has no popcount op, so the plain versions
here spend a dozen SWAR operations on every popcount, and a slot goes
to two hand kernels in ``csrc/slots.cu`` instead:

* ``slot_planes``    — stage 1: read the candidates' rows of the
                       chunk-major inventory ``have_t`` (one row a
                       chunk, bit v for peer v), turn each 32 x 32 bit
                       tile of (candidate, receiver) around into
                       receiver rows in rarest-first bit order, apply
                       the owner-window gate, and build the supply tier
                       planes, the need plane, the need counts and
                       ``sup_any``, without the (n, m_pad) bit matrix
                       the JAX code materialises;
* ``slot_rounds``    — every grant round of the slot in one persistent
                       cooperative launch (the JAX package's
                       ``lax.while_loop``): feasibility, scores, GFF
                       retries, overlap counts, the grouped tau gate and
                       uplink split, and the ranked extraction, with
                       ``rounds`` and the two grids left on the device.

``overlap_rank`` and ``extract_ranked`` run two of ``slot_rounds``' row
bodies alone, one CTA a row, so they can be held against their plain
versions on their own:

* ``overlap_rank``   — the fused gather, AND and popcount of
                       ``plane_a[u_c] & need`` into its (n, S)
                       superblock cumsum, and the owner tier's totals
                       (``_rank_counts`` of the JAX code);
* ``extract_ranked`` — the first ``take`` set bits of ``plane_a[u_c] &
                       need`` (``t_a`` of them) and then of
                       ``plane_b[u_c] & need``, as column ids, cleared
                       from ``need`` in place (``_extract_ranked`` and
                       ``_first_bits`` with the tier merge).

Words are int32 tensors holding the uint32 bit patterns of the JAX
package's words (CUDA ops lack ``torch.uint32``); the helpers read them
through int64 (``_u32``), so shifts never sign-extend and products wrap
mod 2**32 without overflowing.  Each wrapper runs its plain version for
tensors on the CPU and launches its kernel for CUDA tensors, counted in
``LAUNCHES``; ``impl="torch"`` asks for the plain version on any device.
"""
from __future__ import annotations

import torch

from . import _build

_MASK32 = 0xFFFFFFFF
_SB = 16                        # superblocks a row when W divides by 16
PLANE_WORDS = 8                 # output words of a row a slot_planes CTA
                                # builds: one 32-byte sector of each plane


# ----------------------------------------------------------------------
# uint32 arithmetic on int tensors
# ----------------------------------------------------------------------

def _u32(x: torch.Tensor) -> torch.Tensor:
    """The uint32 value of each element's low 32 bits, as int64."""
    return x.to(torch.int64) & _MASK32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same bit pattern."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2**32 for uint32 values x (int64), in 16-bit halves of
    ``c`` so that no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (SWAR), as int32."""
    v = _u32(x)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def _kth_set_bit(word: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Bit index of the ``k``-th (0-based) set bit of each word.

    Five-level binary descent over word halves (16/8/4/2/1); undefined
    when ``k >= popcount(word)`` (callers mask those lanes).
    """
    w = _u32(word)
    kk = k.to(torch.int32)
    bit = torch.zeros_like(kk)
    for half in (16, 8, 4, 2, 1):
        lo = w & ((1 << half) - 1)
        c = popcount(lo)
        hi = kk >= c
        kk = kk - torch.where(hi, c, 0)
        bit = bit + torch.where(hi, half, 0).to(torch.int32)
        w = torch.where(hi, w >> half, lo)
    return bit


def _rank_counts(rows: torch.Tensor) -> torch.Tensor:
    """Per-superblock inclusive popcount cumsum (n, S) of a packed plane
    (S = 16 superblocks, or 1 when W is not divisible); its last column
    is each row's total popcount."""
    n, w = rows.shape
    s = _SB if w % _SB == 0 else 1
    sb = popcount(rows).reshape(n, s, w // s).sum(2, dtype=torch.int32)
    return torch.cumsum(sb, 1, dtype=torch.int32)


def _extract_ranked(rows: torch.Tensor, sb_cum: torch.Tensor,
                    want: torch.Tensor, t_cap: int):
    """First ``want[i]`` set bits of each packed row, lowest first.

    ``sb_cum`` is the plane's :func:`_rank_counts`.  Returns ``(sel,
    cols)``: the selected bits as a plane of the same shape and the
    (n, t_cap) word*32+bit column ids (-1 past the batch), by the JAX
    package's hierarchical rank search: superblock from the cumsum,
    word from a cumsum over that superblock's words, bit by
    :func:`_kth_set_bit`.
    """
    n, w = rows.shape
    s = sb_cum.shape[1]
    b = w // s
    dev = rows.device
    ridx = torch.arange(n, device=dev)
    total = sb_cum[:, -1]
    ks = torch.arange(t_cap, dtype=torch.int32, device=dev)
    # superblock holding rank k: first s with sb_cum[s] > k
    sbk = (sb_cum[:, None, :] <= ks[None, :, None]).sum(
        2, dtype=torch.int32).clamp(max=s - 1)
    prev_sb = torch.where(
        sbk > 0,
        sb_cum.gather(1, (sbk - 1).clamp(min=0).long()), 0)
    k_in = ks[None, :] - prev_sb                       # rank in superblock
    widx = (sbk[:, :, None].long() * b
            + torch.arange(b, device=dev)[None, None, :])
    words = rows[ridx[:, None, None], widx]            # (n, t_cap, B)
    wcum = torch.cumsum(popcount(words), 2, dtype=torch.int32)
    wk_in = (wcum <= k_in[:, :, None]).sum(
        2, dtype=torch.int32).clamp(max=b - 1)
    prev_w = torch.where(
        wk_in > 0,
        wcum.gather(2, (wk_in - 1).clamp(min=0).long()[..., None])[..., 0],
        0)
    word = words.gather(2, wk_in.long()[..., None])[..., 0]
    bit = _kth_set_bit(word, k_in - prev_w)
    wk = sbk * b + wk_in
    valid = (ks[None, :] < want[:, None]) & (ks[None, :] < total[:, None])
    cols = torch.where(valid, wk * 32 + bit, -1).to(torch.int32)
    one = torch.ones((), dtype=torch.int64, device=dev)
    vals = _i32(torch.where(valid, one << bit.long(), 0))
    sel = torch.zeros_like(rows)
    sel.index_put_((ridx[:, None].expand(n, t_cap), wk.long()), vals,
                   accumulate=True)
    return sel, cols


def _first_bits(rows: torch.Tensor, want: torch.Tensor, t_cap: int):
    """:func:`_extract_ranked` with the rank pass folded in."""
    return _extract_ranked(rows, _rank_counts(rows), want, t_cap)


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------

def slot_planes_plain(have_t, cand, owner, allowed, recv_ok, m_cnt: int, *,
                      nonowner: bool, ungated: bool):
    """Stage 1 of ``_slot_rounds`` as the JAX package writes it, over
    the chunk-major inventory.

    have_t (universe, n_wp) int32 words, bit ``v & 31`` of word ``v >>
    5`` of row c set when peer v holds chunk c (bits of peers at or
    above n are ignored); cand, owner (m_pad,) int32 (the candidate
    chunk ids in rarest-first order, their owners); allowed (m_pad,)
    bool (the owner window is open); recv_ok (n,) bool; the first
    ``m_cnt`` candidates are real, the rest pad.  Returns ``(plane_a,
    plane_b, need, need_cnt, sup_any)``: plane_a is the supply plane
    (``nonowner``: its non-owner tier, plane_b its owner tier; else
    plane_b is None), need the receivers' missing candidate bits,
    need_cnt (n,) int32 and sup_any (n,) bool.
    """
    n = recv_ok.shape[0]
    m_pad = cand.shape[0]
    w_words = m_pad // 32
    dev = have_t.device
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    cidx = torch.arange(m_pad, device=dev)
    valid = cidx < m_cnt
    col_w = cidx >> 5
    col_b = cidx & 31
    one = torch.ones((), dtype=torch.int64, device=dev)
    col_bit = torch.where(valid, one << col_b, 0)
    # the candidates' rows, unpacked to (m_pad, n) bits and turned
    # around: from here on the JAX package's stage 1
    rows = (_u32(have_t[cand.long()])[:, :, None] >> shifts) & 1
    bits = rows.reshape(m_pad, -1)[:, :n].T
    bits = torch.where(valid[None, :], bits, 0)
    hv_w = (bits.reshape(n, w_words, 32) << shifts).sum(2)
    valid_w = (valid.reshape(w_words, 32).long() << shifts).sum(1)
    owner_l = owner.long()
    own_w = None
    if nonowner or not ungated:
        own_w = torch.zeros((n, w_words), dtype=torch.int64, device=dev)
        own_w.index_put_((owner_l, col_w), col_bit, accumulate=True)
    if ungated:
        sup_w = hv_w
    else:
        # eligible_supply's owner fix-up: each column has exactly one
        # owner cell; clear it, then restore iff the window is open and
        # the owner holds the chunk.
        have_own = (hv_w[owner_l, col_w] >> col_b) & 1
        set_bit = torch.where(allowed & (have_own > 0), col_bit, 0)
        own_set = torch.zeros((n, w_words), dtype=torch.int64, device=dev)
        own_set.index_put_((owner_l, col_w), set_bit, accumulate=True)
        sup_w = (hv_w & ~own_w) | own_set
    need_w = torch.where(recv_ok[:, None], ~hv_w & valid_w[None, :], 0)
    need_cnt = popcount(need_w).sum(1, dtype=torch.int32)
    sup_any = popcount(sup_w).sum(1) > 0
    if nonowner:
        return (_i32(sup_w & ~own_w), _i32(sup_w & own_w), _i32(need_w),
                need_cnt, sup_any)
    return _i32(sup_w), None, _i32(need_w), need_cnt, sup_any


def overlap_rank_plain(plane_a, plane_b, need, u_c):
    """``_rank_counts(plane_a[u_c] & need)`` (n, S) and the totals of
    ``plane_b[u_c] & need`` (n,) int32 (zeros without plane_b)."""
    sbc = _rank_counts(plane_a[u_c] & need)
    if plane_b is None:
        return sbc, torch.zeros(need.shape[0], dtype=torch.int32,
                                device=need.device)
    return sbc, popcount(plane_b[u_c] & need).sum(1, dtype=torch.int32)


def extract_ranked_plain(plane_a, plane_b, need, u_c, take, t_a, sbc,
                         t_cap: int):
    """Column ids (n, t_cap) int32 of each row's grant, and ``need``
    cleared of them in place.

    Row v takes the first ``t_a[v]`` set bits of ``plane_a[u_c[v]] &
    need[v]`` (``sbc`` is that plane's :func:`_rank_counts`), then,
    with plane_b, the first ``take[v] - t_a[v]`` of ``plane_b[u_c[v]]
    & need[v]``; -1 past the grant.  Needs 0 <= t_a <= take <= t_cap,
    and, without plane_b, t_a == take.
    """
    sel, cols = _extract_ranked(plane_a[u_c] & need, sbc, t_a, t_cap)
    if plane_b is not None:
        sel_b, cols_b = _first_bits(plane_b[u_c] & need, take - t_a, t_cap)
        sel = sel | sel_b
        ks = torch.arange(t_cap, device=need.device)[None, :]
        shift = (ks - t_a[:, None]).clamp(0, t_cap - 1)
        cols = torch.where(ks < t_a[:, None], cols,
                           cols_b.gather(1, shift.long()))
        cols = torch.where(ks < take[:, None], cols, -1).to(torch.int32)
    need.bitwise_and_(~sel)
    return cols


_GFF_RETRIES = 3          # loser re-picks per round, as the batched engine
_U01 = 2.0 ** -32         # uint32 -> [0, 1)


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


def grouped_take(u_v, req, recv_prio, is_new, recv_slots, rem_up, n: int):
    """A round's grants (n,) int32 from its pairs, by one global sort.

    Receivers pair with ``u_v`` (n when unpaired) and ask for ``req``.
    Within each sender's group, in ascending ``(recv_prio + 0.0, v)``
    order, only the first ``recv_slots[u]`` NEW pairs (``is_new``) may
    open a serve slot (the tau gate), and each grant is capped at what
    ``rem_up[u]`` leaves after the members before it (the uplink split).
    """
    # lexsort((recv_prio, u_v)): two stable sorts; + 0.0 makes a
    # -0.0 priority +0.0, which the JAX comparator treats as equal
    order = torch.sort(recv_prio + 0.0, stable=True).indices
    order = order[torch.sort(u_v[order], stable=True).indices]
    us = u_v[order]
    us_c = us.clamp(max=n - 1)
    reqs = req[order].long()
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
    take = torch.zeros(n, dtype=torch.int32, device=u_v.device)
    take[order] = take_s.to(torch.int32)
    return take


def slot_rounds_plain(plane_a, plane_b, need, need_cnt, sup_any, nbr,
                      rem_up, rem_down, bases, *, mode_id: int, t_cap: int,
                      r_max: int, batch_cap: int, tau: int):
    """Every grant round of a slot as the JAX package's loop body, one
    Python iteration a round with one host read (``pair.any()``).

    The planes, ``need_cnt`` and ``sup_any`` are ``slot_planes``'
    outputs; nbr (n, d_pad) int32 neighbor lists, -1 pad; rem_up and
    rem_down (n,) int32 budgets; ``bases`` the (noise (n, d_pad), tie
    (n,), prio (n,)) int32 words.  Carries the need plane, the remaining
    uplink/downlink and tau budgets, the serving and tombstone pair masks
    and the fixed-shape output grids; every round is fully masked; no
    argument is changed.  Returns ``(out_snd, out_col, rounds)``: per
    (round, receiver) the granted sender (-1 none) and its rarest-first
    column batch (-1 pad), non-owner tier first within each grant, as
    (r_max, n) and (r_max, n, t_cap) int32 grids (rows past ``rounds``
    are -1), and how many rounds ran, as a (1,) int32 tensor.
    """
    n = need.shape[0]
    dev = need.device
    i32 = dict(dtype=torch.int32, device=dev)
    need = need.clone()
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
        sbc, cnt_b = overlap_rank_plain(plane_a, plane_b, need, u_c)
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
        is_new = pair & ~serving[vidx, d_v]
        take = grouped_take(u_v, req, recv_prio, is_new, recv_slots, rem_up,
                            n)
        granted = take > 0

        # Non-owner-first WITHIN each grant: fill from the non-owner
        # overlap, owner chunks only for the remainder (both tiers in
        # one extraction, so no host read decides whether to run the
        # owner tier).
        t_a = torch.minimum(take, cnt_a) if plane_b is not None else take
        cols = extract_ranked_plain(plane_a, plane_b, need, u_c, take, t_a,
                                    sbc, t_cap)

        need_cnt = need_cnt - take
        rem_down = rem_down - take
        rem_up.index_add_(0, u_c, torch.where(granted, -take, 0))
        fresh = granted & is_new
        serving[vidx, d_v] = serving[vidx, d_v] | fresh
        recv_slots.index_add_(0, u_c, -fresh.to(torch.int32))
        out_snd[r] = torch.where(granted, u_v.to(torch.int32), -1)
        out_col[r] = cols
        if not bool(pair.any()):
            break
    return out_snd, out_col, torch.tensor([rounds], **i32)


# ----------------------------------------------------------------------
# CUDA wrappers
# ----------------------------------------------------------------------

def _check(name, tensors: dict, dtype) -> None:
    for arg, t in tensors.items():
        if t.dtype != dtype:
            raise ValueError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def slot_planes(have_t, cand, owner, allowed, recv_ok, m_cnt: int, *,
                nonowner: bool, ungated: bool, impl: str = "cuda"):
    """:func:`slot_planes_plain` through the ``slot_planes`` kernel.

    The kernel wants ``have_t``'s row length ``n_wp`` a multiple of 8
    words (``jit_engine._n_wp``) and the tensor 16-byte aligned.  A CTA
    builds ``min(PLANE_WORDS, W)`` output words of 256 receiver rows, so
    W must be a power of two below ``PLANE_WORDS`` or a multiple of it.
    Rows whose words span CTAs merge their counts through tickets that
    the kernel keeps in static device memory, one array a device: calls
    on one device must not overlap in time (one stream, as the engine
    makes them)."""
    if impl == "torch" or have_t.device.type == "cpu":
        return slot_planes_plain(have_t, cand, owner, allowed, recv_ok,
                                 m_cnt, nonowner=nonowner, ungated=ungated)
    if impl != "cuda":
        raise ValueError(f"unknown slot_planes impl {impl!r}")
    _build.require_cuda("slot_planes", have_t, cand, owner, allowed,
                        recv_ok)
    _check("slot_planes", {"have_t": have_t, "cand": cand, "owner": owner},
           torch.int32)
    _check("slot_planes", {"allowed": allowed, "recv_ok": recv_ok},
           torch.bool)
    n, m_pad = recv_ok.shape[0], cand.shape[0]
    n_wp = have_t.shape[1] if have_t.dim() == 2 else -1
    if (n_wp % 8 or n_wp * 32 < n or have_t.data_ptr() % 16
            or m_pad % 32 or owner.shape != (m_pad,)
            or allowed.shape != (m_pad,) or recv_ok.dim() != 1
            or not 0 <= m_cnt <= m_pad):
        raise ValueError("slot_planes: want have_t (universe, n_wp), "
                         "16-byte aligned, with n_wp a multiple of 8 and "
                         "n_wp * 32 >= n; cand, owner and allowed (m_pad,) "
                         "with m_pad % 32 == 0, recv_ok (n,) and 0 <= m_cnt "
                         "<= m_pad")
    w_words = m_pad // 32
    dev = have_t.device
    wb = min(PLANE_WORDS, w_words)         # the kernel's words a CTA
    if wb < 1 or w_words % wb or wb & (wb - 1):
        raise ValueError(f"slot_planes: W = {w_words} words must be a power "
                         f"of two below {PLANE_WORDS} or a multiple of it")
    kw = dict(dtype=torch.int32, device=dev)
    plane_a = torch.empty((n, w_words), **kw)
    plane_b = torch.empty((n, w_words) if nonowner else (0,), **kw)
    need = torch.empty((n, w_words), **kw)
    need_cnt = torch.empty((n,), **kw)
    sup_any = torch.empty((n,), dtype=torch.bool, device=dev)
    chunks = w_words // wb
    partial = torch.empty((chunks if chunks > 1 else 0, n), **kw)
    _build.extension().slot_planes(
        have_t, cand, owner, allowed, recv_ok, m_cnt, nonowner, ungated,
        plane_a, plane_b, need, need_cnt, sup_any, partial)
    _build.LAUNCHES["slot_planes"] += 1
    return (plane_a, plane_b if nonowner else None, need, need_cnt,
            sup_any)


def _check_round(name, plane_a, plane_b, need, u_c) -> None:
    _build.require_cuda(name, plane_a, need, u_c,
                        *(() if plane_b is None else (plane_b,)))
    planes = {"plane_a": plane_a, "need": need}
    if plane_b is not None:
        planes["plane_b"] = plane_b
    _check(name, planes, torch.int32)
    _check(name, {"u_c": u_c}, torch.int64)
    n = need.shape[0]
    if any(p.shape != need.shape for p in planes.values()) \
            or u_c.shape != (n,) or need.dim() != 2:
        raise ValueError(f"{name}: the planes must share need's (n, W) "
                         f"shape and u_c must be ({n},)")


def overlap_rank(plane_a, plane_b, need, u_c, *, impl: str = "cuda"):
    """:func:`overlap_rank_plain` through the ``overlap_rank`` kernel."""
    if impl == "torch" or need.device.type == "cpu":
        return overlap_rank_plain(plane_a, plane_b, need, u_c)
    if impl != "cuda":
        raise ValueError(f"unknown overlap_rank impl {impl!r}")
    _check_round("overlap_rank", plane_a, plane_b, need, u_c)
    n, w_words = need.shape
    s = _SB if w_words % _SB == 0 else 1
    sbc = torch.empty((n, s), dtype=torch.int32, device=need.device)
    cnt_b = torch.empty((n,), dtype=torch.int32, device=need.device)
    _build.extension().overlap_rank(
        plane_a, plane_a if plane_b is None else plane_b, plane_b is not None,
        need, u_c, sbc, cnt_b)
    _build.LAUNCHES["overlap_rank"] += 1
    return sbc, cnt_b


def extract_ranked(plane_a, plane_b, need, u_c, take, t_a, sbc,
                   t_cap: int, *, impl: str = "cuda"):
    """:func:`extract_ranked_plain` through the ``extract_ranked``
    kernel (``need`` is updated in place)."""
    if impl == "torch" or need.device.type == "cpu":
        return extract_ranked_plain(plane_a, plane_b, need, u_c, take, t_a,
                                    sbc, t_cap)
    if impl != "cuda":
        raise ValueError(f"unknown extract_ranked impl {impl!r}")
    _check_round("extract_ranked", plane_a, plane_b, need, u_c)
    _build.require_cuda("extract_ranked", need, take, t_a, sbc)
    _check("extract_ranked", {"take": take, "t_a": t_a, "sbc": sbc},
           torch.int32)
    n, w_words = need.shape
    s = _SB if w_words % _SB == 0 else 1
    if take.shape != (n,) or t_a.shape != (n,) or sbc.shape != (n, s) \
            or t_cap < 1:
        raise ValueError(f"extract_ranked: want take and t_a ({n},), sbc "
                         f"({n}, {s}) and t_cap >= 1")
    cols = torch.empty((n, t_cap), dtype=torch.int32, device=need.device)
    _build.extension().extract_ranked(
        plane_a, plane_a if plane_b is None else plane_b, plane_b is not None,
        need, u_c, take, t_a, sbc, cols)
    _build.LAUNCHES["extract_ranked"] += 1
    return cols


def slot_rounds(plane_a, plane_b, need, need_cnt, sup_any, nbr, in_nbr,
                rem_up, rem_down, bases, *, mode_id: int, t_cap: int,
                r_max: int, batch_cap: int, tau: int, impl: str = "cuda"):
    """:func:`slot_rounds_plain` through the ``slot_rounds`` kernel.

    ``in_nbr`` (n, din_pad) int32 lists, for each sender u, the rows v
    with u in ``nbr[v]`` (-1 pad); the kernel's sender phases walk it,
    and the plain version does not read it.  Both leave ``rounds`` on
    the device as a (1,) int32 tensor.  Raises where the device has no
    cooperative launch.
    """
    kw = dict(mode_id=mode_id, t_cap=t_cap, r_max=r_max,
              batch_cap=batch_cap, tau=tau)
    if impl == "torch" or need.device.type == "cpu":
        return slot_rounds_plain(plane_a, plane_b, need, need_cnt, sup_any,
                                 nbr, rem_up, rem_down, bases, **kw)
    if impl != "cuda":
        raise ValueError(f"unknown slot_rounds impl {impl!r}")
    noise, tie, prio = bases
    planes = {"plane_a": plane_a, "need": need}
    if plane_b is not None:
        planes["plane_b"] = plane_b
    ints = {"need_cnt": need_cnt, "nbr": nbr, "in_nbr": in_nbr,
            "rem_up": rem_up, "rem_down": rem_down, "noise": noise,
            "tie": tie, "prio": prio}
    _build.require_cuda("slot_rounds", sup_any, *planes.values(),
                        *ints.values())
    _check("slot_rounds", {**planes, **ints}, torch.int32)
    _check("slot_rounds", {"sup_any": sup_any}, torch.bool)
    n, w_words = need.shape
    d_pad = nbr.shape[1] if nbr.dim() == 2 else -1
    if (any(t.shape != need.shape for t in planes.values())
            or nbr.shape != (n, d_pad) or noise.shape != (n, d_pad)
            or in_nbr.dim() != 2 or in_nbr.shape[0] != n
            or any(t.shape != (n,) for t in (need_cnt, sup_any, rem_up,
                                              rem_down, tie, prio))
            or mode_id not in (0, 1, 2) or t_cap < 1 or r_max < 1):
        raise ValueError("slot_rounds: want planes (n, W), nbr and the "
                         "noise base (n, d_pad), in_nbr (n, din_pad), "
                         "need_cnt, sup_any, rem_up, rem_down and the tie "
                         "and prio bases (n,), mode_id 0, 1 or 2, t_cap "
                         "and r_max >= 1")
    ext = _build.extension()
    kw_dev = dict(dtype=torch.int32, device=need.device)
    scratch = torch.empty(ext.slot_rounds_scratch_words(
        n, w_words, d_pad, r_max, mode_id), **kw_dev)
    out_snd = torch.empty((r_max, n), **kw_dev)
    out_col = torch.empty((r_max, n, t_cap), **kw_dev)
    rounds = torch.empty((1,), **kw_dev)
    ext.slot_rounds(plane_a, plane_a if plane_b is None else plane_b,
                    plane_b is not None, need, need_cnt, sup_any, nbr,
                    in_nbr, rem_up, rem_down, noise, tie, prio, mode_id,
                    min(batch_cap, 2 ** 31 - 1), tau, out_snd, out_col,
                    rounds, scratch)
    _build.LAUNCHES["slot_rounds"] += 1
    return out_snd, out_col, rounds


__all__ = ["popcount", "slot_planes", "slot_planes_plain", "overlap_rank",
           "overlap_rank_plain", "extract_ranked", "extract_ranked_plain",
           "slot_rounds", "slot_rounds_plain", "grouped_take"]
