"""Bitplane kernels of the GPU slot engine (``core/jit_engine.py``).

The JAX package computes a slot's plane work as plain ``lax`` code over
packed uint32 words (``repro/core/jit_engine.py::_slot_rounds``): no
TPU kernel is behind any of it.  torch has no popcount op, so the
plain versions here spend a dozen SWAR operations on every popcount,
and the plane work of a slot goes to three hand kernels in
``csrc/slots.cu`` instead:

* ``slot_planes``    — stage 1: gather the candidate columns out of the
                       packed inventory in rarest-first bit order,
                       apply the owner-window gate, and build the
                       supply tier planes, the need plane, the need
                       counts and ``sup_any``, without the (n, m_pad)
                       bit matrix the JAX code materialises;
* ``overlap_rank``   — per grant round: the fused gather, AND and
                       popcount of ``plane_a[u_c] & need`` into its
                       (n, S) superblock cumsum, and the owner tier's
                       totals (``_rank_counts`` of the JAX code);
* ``extract_ranked`` — per grant round: the first ``take`` set bits of
                       ``plane_a[u_c] & need`` (``t_a`` of them) and then
                       of ``plane_b[u_c] & need``, as column ids, cleared
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

def slot_planes_plain(have, cand, owner, allowed, recv_ok, m_cnt: int, *,
                      nonowner: bool, ungated: bool):
    """Stage 1 of ``_slot_rounds`` as the JAX package writes it.

    have (n, w_full) int32 words; cand, owner (m_pad,) int32 (the
    candidate chunk ids in rarest-first order, their owners); allowed
    (m_pad,) bool (the owner window is open); recv_ok (n,) bool; the
    first ``m_cnt`` candidates are real, the rest pad.  Returns
    ``(plane_a, plane_b, need, need_cnt, sup_any)``: plane_a is the
    supply plane (``nonowner``: its non-owner tier, plane_b its owner
    tier; else plane_b is None), need the receivers' missing candidate
    bits, need_cnt (n,) int32 and sup_any (n,) bool.
    """
    n = have.shape[0]
    m_pad = cand.shape[0]
    w_words = m_pad // 32
    dev = have.device
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    cidx = torch.arange(m_pad, device=dev)
    valid = cidx < m_cnt
    col_w = cidx >> 5
    col_b = cidx & 31
    one = torch.ones((), dtype=torch.int64, device=dev)
    col_bit = torch.where(valid, one << col_b, 0)
    cand_l = cand.long()
    bits = (_u32(have[:, cand_l >> 5]) >> (cand_l & 31)[None, :]) & 1
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


# ----------------------------------------------------------------------
# CUDA wrappers
# ----------------------------------------------------------------------

def _check(name, tensors: dict, dtype) -> None:
    for arg, t in tensors.items():
        if t.dtype != dtype:
            raise ValueError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def slot_planes(have, cand, owner, allowed, recv_ok, m_cnt: int, *,
                nonowner: bool, ungated: bool, impl: str = "cuda"):
    """:func:`slot_planes_plain` through the ``slot_planes`` kernel."""
    if impl == "torch" or have.device.type == "cpu":
        return slot_planes_plain(have, cand, owner, allowed, recv_ok,
                                 m_cnt, nonowner=nonowner, ungated=ungated)
    if impl != "cuda":
        raise ValueError(f"unknown slot_planes impl {impl!r}")
    _build.require_cuda("slot_planes", have, cand, owner, allowed, recv_ok)
    _check("slot_planes", {"have": have, "cand": cand, "owner": owner},
           torch.int32)
    _check("slot_planes", {"allowed": allowed, "recv_ok": recv_ok},
           torch.bool)
    n, m_pad = have.shape[0], cand.shape[0]
    if (have.dim() != 2 or m_pad % 32 or owner.shape != (m_pad,)
            or allowed.shape != (m_pad,) or recv_ok.shape != (n,)
            or not 0 <= m_cnt <= m_pad):
        raise ValueError("slot_planes: want have (n, w_full), cand, owner "
                         "and allowed (m_pad,) with m_pad % 32 == 0, "
                         "recv_ok (n,) and 0 <= m_cnt <= m_pad")
    w_words = m_pad // 32
    kw = dict(dtype=torch.int32, device=have.device)
    plane_a = torch.empty((n, w_words), **kw)
    plane_b = torch.empty((n, w_words) if nonowner else (0,), **kw)
    need = torch.empty((n, w_words), **kw)
    need_cnt = torch.empty((n,), **kw)
    sup_any = torch.empty((n,), dtype=torch.bool, device=have.device)
    _build.extension().slot_planes(have, cand, owner, allowed, recv_ok,
                                   m_cnt, nonowner, ungated, plane_a,
                                   plane_b, need, need_cnt, sup_any)
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


__all__ = ["popcount", "slot_planes", "slot_planes_plain", "overlap_rank",
           "overlap_rank_plain", "extract_ranked", "extract_ranked_plain"]
