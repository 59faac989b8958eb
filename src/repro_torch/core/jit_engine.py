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
  boolean masks; the rounds stop at the first that finds no feasible
  (receiver, sender) pair.
* **schedule legality is engine-independent**: budgets, tau, adjacency,
  duplicate-freedom and the Eq. 1 gate hold as in the loop and batched
  engines.

Where the JAX package stages one ``lax.while_loop``, the port runs a
slot on the card as two hand kernels (``kernels/slots.py``):
``slot_planes`` builds the planes, then ``slot_rounds`` runs every grant
round in one persistent cooperative launch and leaves ``rounds`` and
the grids on the device, so a slot makes two host reads (``rounds``,
then the grids; ``COUNTS``).  Its sender phases walk each sender's
in-neighbor list, cached on the state beside the neighbor lists.  On
the CPU, or with ``impl="torch"``, the rounds run as the plain loop
``slot_rounds_plain``: torch ops and one host read a round.

Words are int32 tensors with the uint32 bit patterns of the JAX
package's words.  The swarm-wide inventory lives on the device
chunk-major, where the JAX package keeps it row-major: ``have_t`` is
``(nK, n_wp)`` words, bit ``v & 31`` of word ``v >> 5`` of row ``c`` set
when peer v holds chunk c, and ``n_wp`` is ``ceil(n / 32)`` rounded up
to a multiple of 8, so every row starts on a 32-byte sector.  Stage 1
then reads only the candidates' rows, each a few hundred contiguous
bytes.  The inventory is synced incrementally from the transfer log by
an in-place accumulating scatter (delivery exactly once makes add and
OR the same), so a slot never re-reads the O(n * nK) boolean ``have``
matrix.

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
                             _kth_set_bit, _mix32, _mul32, _rank_counts,
                             _salted, _u32)
from .state import SwarmState

_MODE_IDS = {"random_fifo": 0, "random_fastest_first": 1,
             "greedy_fastest_first": 2}
_BIG = 1 << 30            # "unbounded" batch cap for the BT phase

# Host-observed wall seconds per engine phase, accumulated across slots
# ("matching" includes the noise draw and the blocking device-to-host
# fetch of the grids).  The measurement clock is injected by the
# benchmarks (set_clock, or simulator.measured_clock); simulated time
# never reads the host clock, so by default the accumulators stay zero.
PHASE_S = {"bitplane_s": 0.0, "matching_s": 0.0, "extraction_s": 0.0}

# Work counts accumulated across slots: slots matched, grant rounds run
# and device-to-host reads (on the card: rounds and the grids, two a
# slot; on the CPU's plain loop: one a round, plus the grids).
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
    """(rows, m) bool -> (rows, w) uint32, bit ``c & 31`` of word
    ``c >> 5`` is column ``c`` (little-endian bit order; pad bits stay
    zero).  Packing ``have.T`` with ``w = _n_wp(n)`` gives the
    chunk-major inventory."""
    p = np.packbits(bits, axis=1, bitorder="little")
    buf = np.zeros((bits.shape[0], w * 4), dtype=np.uint8)
    buf[:, :p.shape[1]] = p
    words = buf.view(np.uint32)
    if not np.little_endian:            # pragma: no cover - x86/arm are LE
        words = words.byteswap()
    return words


def _n_wp(n: int) -> int:
    """Words a chunk-major inventory row: ``ceil(n / 32)`` rounded up to
    a multiple of 8, so each row starts on a 32-byte sector."""
    return -(-n // 256) * 8


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


def _transpose_lists(nbr: np.ndarray) -> np.ndarray:
    """Padded (n, din_pad) int32 in-neighbor lists (-1 pad) of padded
    neighbor lists: row u lists, ascending, every v with u in nbr[v].
    No symmetry is assumed."""
    n = nbr.shape[0]
    v, d = np.nonzero(nbr >= 0)
    u = nbr[v, d].astype(np.int64)
    order = np.lexsort((v, u))
    u, v = u[order], v[order]
    deg = np.bincount(u, minlength=n)
    din_pad = _pow2(max(int(deg.max(initial=1)), 1))
    out = np.full((n, din_pad), -1, dtype=np.int32)
    first = np.searchsorted(u, np.arange(n))
    out[u, np.arange(u.size) - first[u]] = v
    return out


def _overlay_lists(state: SwarmState):
    """Device (nbr, in_nbr) lists of the state's overlay: padded (n,
    d_pad) neighbor lists and their (n, din_pad) transpose (-1 pad),
    cached on the state so every slot reuses one upload, and rebuilt
    when ``state.adj`` is replaced."""
    cached = getattr(state, "_jit_nbr_cache", None)
    if cached is not None and cached[0] is state.adj:
        return cached[1], cached[2]
    adj = state.adj
    n = adj.shape[0]
    deg = adj.sum(axis=1)
    d_pad = _pow2(max(int(deg.max(initial=1)), 1))
    nbr = np.full((n, d_pad), -1, dtype=np.int32)
    rows, cols = np.nonzero(adj)
    first = np.searchsorted(rows, np.arange(n))
    nbr[rows, np.arange(rows.size) - first[rows]] = cols
    dev = _device(state)
    cached = (adj, _upload(nbr, dev), _upload(_transpose_lists(nbr), dev))
    state._jit_nbr_cache = cached
    return cached[1], cached[2]


def _neighbor_lists(state: SwarmState) -> torch.Tensor:
    """Padded (n, d_pad) int32 neighbor lists (-1 pad) for the round's
    static overlay, on the engine's device (``_overlay_lists``)."""
    return _overlay_lists(state)[0]


def _scatter_bits(words: torch.Tensor, rows, wcol, vals) -> torch.Tensor:
    # Delivery-exactly-once (state.apply_transfers de-dups against
    # ``have``) keeps every (chunk, peer) bit unique for the whole round,
    # so add == bitwise-or; pad entries carry vals == 0.  In place.
    return words.index_put_((rows.long(), wcol.long()), vals,
                            accumulate=True)


def _log_scatter(state: SwarmState, pos: int, nb: int):
    """Scatter operands (chunk row, peer word column, bit value) into
    the chunk-major inventory for transfer-log batches ``[pos:nb)``,
    padded to a power of two with zero values, on the engine's device
    (vals: uint32 bits as int32)."""
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
    rows[:rcv.size] = chk
    wcol[:rcv.size] = rcv >> 5
    vals[:rcv.size] = np.left_shift(
        np.uint32(1), (rcv & 31).astype(np.uint32))
    dev = _device(state)
    return _upload(rows, dev), _upload(wcol, dev), _upload(vals, dev)


def _diag_words(state: SwarmState, dev) -> torch.Tensor:
    """Chunk-major owner-diagonal inventory on ``dev`` (chunk c is held
    by its owner c // K alone), the analytic post-construction state:
    one bit a row, set where the words live, so nothing is packed or
    uploaded."""
    chunk = torch.arange(state.have.shape[1], device=dev)
    owner = chunk // state.cfg.chunks_per_update
    words = torch.zeros((chunk.numel(), _n_wp(state.cfg.n)),
                        dtype=torch.int32, device=dev)
    bit = (owner & 31).int()
    # int32 shifts wrap: 1 << 31 is the word 0x80000000
    words[chunk, owner >> 5] = torch.ones_like(bit) << bit
    return words


def _sync_have_dev(state: SwarmState) -> torch.Tensor:
    """Device copy of the chunk-major packed inventory ``have_t``,
    synced incrementally.

    The transfer log is the single write path for ``state.have`` after
    construction, so replaying batches appended since the last call
    reproduces the matrix bit for bit.  A swapped ``have`` identity
    (Byzantine claimed inventories) falls back to a full repack.  Bits
    of peers at or above n stay zero.
    """
    nb = len(state.log.receivers)
    cache = getattr(state, "_jit_have_cache", None)
    if cache is not None and cache[0] is state.have:
        dev, pos = cache[1], cache[2]
        if pos < nb:
            dev = _scatter_bits(dev, *_log_scatter(state, pos, nb))
        state._jit_have_cache = (state.have, dev, nb)
        return dev
    if cache is None and state.have is getattr(
            state, "_have_pristine", None):
        # First build of the genuine inventory: the owner diagonal is
        # analytic and the log already records every later delivery, so
        # building it on the device skips an np.packbits pass over the
        # multi-GB bool matrix and the upload of the packed words.
        dev = _scatter_bits(_diag_words(state, _device(state)),
                            *_log_scatter(state, 0, nb))
        state._jit_have_cache = (state.have, dev, nb)
        return dev
    dev = _upload(_pack_words(state.have.T, _n_wp(state.cfg.n)),
                  _device(state))
    state._jit_have_cache = (state.have, dev, nb)
    return dev


# ----------------------------------------------------------------------
# Device side
# ----------------------------------------------------------------------

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
                 t_cap: int, r_max: int, have_t, cand, owner_row,
                 own_allowed, m_cnt: int, recv_ok, nbr, rem_up, rem_down,
                 batch_cap: int, tau: int, bases, in_nbr, *,
                 impl: str = "cuda"):
    """One slot: plane build plus budgeted-round matching.

    Stage 1 (``slot_planes``) gathers the candidates' rows out of the
    device-resident chunk-major inventory ``have_t`` (``_sync_have_dev``),
    turns them into receiver rows in rarest-first bit order and applies
    the owner-window gate.  Stage 2 (``slot_rounds``) runs the
    grant rounds, carrying the need planes, the remaining uplink/downlink
    and tau budgets, the serving and tombstone pair masks and the
    fixed-shape output grids; every round is fully masked.  ``bases``
    are the (noise (n, d_pad), tie (n,), prio (n,)) int32 words that the
    JAX package draws from ``seed`` inside its kernel; ``in_nbr`` is the
    transpose of ``nbr`` (``_overlay_lists``).  The kernels run on CUDA
    tensors, their plain versions on CPU ones or with ``impl="torch"``.

    Returns ``(out_snd, out_col, rounds)``: per (round, receiver) the
    granted sender (-1 none) and its rarest-first column batch (-1 pad),
    non-owner tier first within each grant, as (r_max, n) and (r_max,
    n, t_cap) int32 grids on the device (rows past ``rounds`` are -1),
    and how many rounds ran.
    """
    dev = have_t.device
    plain = impl == "torch" or dev.type == "cpu"
    plane_a, plane_b, need, need_cnt, sup_any = _k.slot_planes(
        have_t, cand, owner_row, own_allowed, recv_ok, m_cnt,
        nonowner=nonowner, ungated=ungated, impl=impl)
    out_snd, out_col, rounds = _k.slot_rounds(
        plane_a, plane_b, need, need_cnt, sup_any, nbr, in_nbr,
        rem_up.to(torch.int32), rem_down.to(torch.int32),
        tuple(b.to(dev) for b in bases), mode_id=mode_id, t_cap=t_cap,
        r_max=r_max, batch_cap=batch_cap, tau=tau, impl=impl)
    rounds = int(rounds)
    COUNTS["host_reads"] += rounds if plain else 1
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
    have_t = _sync_have_dev(state)
    nbr_dev, in_dev = _overlay_lists(state)
    _t1 = _clock()
    dev = have_t.device
    bases = _draw_bases(seed, n, nbr_dev.shape[1])
    out_snd, out_col, rounds = _slot_rounds(
        _MODE_IDS[mode], nonowner_pass, ungated, t_cap, r_max, have_t,
        _upload(cand_p, dev), _upload(owner_p, dev),
        _upload(allowed_p, dev), m, _upload(recv_ok, dev), nbr_dev,
        _upload(rem_up, dev), _upload(rem_down, dev),
        min(batch_cap, _BIG), int(cfg.tau_concurrent), bases, in_dev)
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

