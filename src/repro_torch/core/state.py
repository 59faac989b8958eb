"""Mutable swarm state for one FLTorrent round (paper §II-B, §IV-A).

Holds the per-client chunk inventories, link budgets, activity masks and
the transfer event log.  Encodes the two warm-up enforcement knobs from
§IV-A exactly:

* **cover-set gating** — an honest sender's owner chunks become eligible
  for upload only once its eligible buffer would reach ``k_gate``
  (equivalently: non-owner mass ``X_u >= k_gate - kappa``), and
* **owner throttling** — at any instant at most ``kappa`` owner chunks
  are eligible (``O_u <= kappa_u``), rotated over slots so every owner
  chunk can eventually circulate.

With both in force, every warm-up transfer from an honest sender has
per-transfer attribution posterior ``O_u / B_u <= kappa / k_gate``
(Eq. 1) — asserted empirically in tests/test_privacy_bounds.py.
"""
from __future__ import annotations

import ctypes
import sys
from dataclasses import dataclass, field

import numpy as np

from .trace import TransferTrace
from .types import SwarmConfig

_MADV_HUGEPAGE = 14          # asm-generic/mman-common.h
_HUGE_2M = 2 * 1024 * 1024


def hint_hugepages(arr: np.ndarray) -> bool:
    """Best-effort ``madvise(MADV_HUGEPAGE)`` over ``arr``'s 2 MiB-aligned
    interior.  With THP in ``madvise`` mode (the common server default)
    this collapses first-touch faulting of a multi-GB mapping from one
    4 KiB fault per page to one per 2 MiB — the difference between a
    ~30 s and a ~3 s inventory fill at n=5000 (BENCH_scheduler.json
    ``setup_s``).  Returns False (harmless no-op) off Linux, on small
    arrays, or when the kernel refuses the hint."""
    if not sys.platform.startswith("linux") or arr.nbytes < _HUGE_2M:
        return False
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        addr = arr.ctypes.data
        start = (addr + _HUGE_2M - 1) & ~(_HUGE_2M - 1)
        end = (addr + arr.nbytes) & ~(_HUGE_2M - 1)
        if end <= start:
            return False
        return libc.madvise(ctypes.c_void_p(start),
                            ctypes.c_size_t(end - start),
                            _MADV_HUGEPAGE) == 0
    except Exception:  # pragma: no cover - exotic libc
        return False


@dataclass
class TransferLog:
    """Struct-of-arrays event log; grown per-slot, finalized once."""

    slots: list = field(default_factory=list)
    senders: list = field(default_factory=list)
    receivers: list = field(default_factory=list)
    chunks: list = field(default_factory=list)
    b_sizes: list = field(default_factory=list)   # B_u at send time
    o_sizes: list = field(default_factory=list)   # O_u at send time
    phases: list = field(default_factory=list)    # 0=spray 1=warmup 2=bt
    t_starts: list = field(default_factory=list)  # wall-clock (event eng.)
    t_ends: list = field(default_factory=list)

    def append(self, slot, snd, rcv, chk, b, o, phase,
               t_start=None, t_end=None):
        if len(snd) == 0:
            return
        self.slots.append(np.full(len(snd), slot, dtype=np.int32))
        self.senders.append(np.asarray(snd, dtype=np.int32))
        self.receivers.append(np.asarray(rcv, dtype=np.int32))
        self.chunks.append(np.asarray(chk, dtype=np.int64))
        self.b_sizes.append(np.asarray(b, dtype=np.int64))
        self.o_sizes.append(np.asarray(o, dtype=np.int64))
        self.phases.append(np.full(len(snd), phase, dtype=np.int8))
        if t_start is not None:
            self.t_starts.append(np.asarray(t_start, dtype=np.float64))
            self.t_ends.append(np.asarray(t_end, dtype=np.float64))

    def finalize(self, chunks_per_update: int,
                 slot_seconds: float = 1.0) -> TransferTrace:
        """Concatenate the per-slot pieces into one typed trace.

        Wall-clock columns: when the event engine stamped every batch,
        its real-valued instants are used; otherwise (slot engines) the
        trace carries slot-boundary stamps in seconds.  Mixing is a
        caller error — one round runs on exactly one time engine.
        """
        if not self.slots:
            return TransferTrace(K=chunks_per_update)
        chunk = np.concatenate(self.chunks)
        times = {}
        if self.t_starts:
            if len(self.t_starts) != len(self.slots):
                raise ValueError(
                    "wall-clock stamps cover only part of the log: "
                    f"{len(self.t_starts)} of {len(self.slots)} batches")
            times = {"t_start": np.concatenate(self.t_starts),
                     "t_end": np.concatenate(self.t_ends)}
        return TransferTrace.from_arrays(
            K=chunks_per_update,
            slot_seconds=slot_seconds,
            slot=np.concatenate(self.slots),
            sender=np.concatenate(self.senders),
            receiver=np.concatenate(self.receivers),
            chunk=chunk,
            owner=(chunk // chunks_per_update).astype(np.int32),
            b_size=np.concatenate(self.b_sizes),
            o_size=np.concatenate(self.o_sizes),
            phase=np.concatenate(self.phases),
            **times,
        )


class SwarmState:
    """Vectorized round state: inventories, budgets, eligibility."""

    def __init__(self, cfg: SwarmConfig, adj: np.ndarray,
                 up: np.ndarray, down: np.ndarray,
                 rng: np.random.Generator):
        n, K = cfg.n, cfg.chunks_per_update
        self.cfg = cfg
        self.adj = adj
        self.up = up.astype(np.int64)
        self.down = down.astype(np.int64)
        self.rng = rng

        C = cfg.total_chunks
        # calloc'd zero pages + a transparent-huge-page hint: with 2 MiB
        # mappings, eagerly faulting the inventory in sequentially costs
        # ~0.5 GB/s-of-zeroing instead of one 4 KiB fault per page (a
        # 10x setup_s cut at n=5000 — BENCH_scheduler.json).  Without
        # the hint (non-Linux / THP disabled) skip the eager fill: lazy
        # zero pages spread the fault cost over apply_transfers writes,
        # which beats an up-front 4 KiB-page fill by ~5x.
        self.have = np.zeros((n, C), dtype=bool)
        if hint_hugepages(self.have):
            flat = self.have.reshape(-1)
            flat[: flat.size - flat.size % 8].view(np.uint64).fill(0)
        self.have[np.repeat(np.arange(n), K),
                  np.arange(n * K, dtype=np.int64)] = True
        # Log-replay invariant marker (see jit_engine._sync_have_dev):
        # after construction, apply_transfers is the only writer of
        # *this* array; schedulers seeing a different object (Byzantine
        # claimed inventories) must repack from scratch.
        self._have_pristine = self.have
        # Per-chunk replication count (rarity), maintained incrementally.
        self.replicas = np.ones(C, dtype=np.int64)
        # Non-owner chunks held per client (X_u in §IV-A).
        self.nonowner = np.zeros(n, dtype=np.int64)
        # Total chunks held per client, maintained incrementally.
        self.hold = np.full(n, K, dtype=np.int64)

        self.active = np.ones(n, dtype=bool)
        if cfg.enable_timelag and cfg.lag_slots > 1:
            self.lag = rng.integers(0, cfg.lag_slots, size=n)
        else:
            self.lag = np.zeros(n, dtype=np.int64)

        self.slot = 0
        self.phase = "warmup"
        self.any_nonowner = False      # swarm-wide non-owner mass exists
        self._win_cache: tuple | None = None   # per-slot owner windows
        self.log = TransferLog()
        self.warmup_sent = 0
        self.bt_sent = 0
        self.per_slot_sent: list[int] = []
        self.owners = np.arange(C, dtype=np.int64) // K

    # -- activity ------------------------------------------------------
    def senders_active(self) -> np.ndarray:
        """Clients allowed to *initiate* transmissions this slot (lags)."""
        return self.active & (self.lag <= self.slot)

    # -- eligibility (paper §IV-A) --------------------------------------
    def eligible_owner_slice(self, u: int) -> np.ndarray:
        """Global chunk ids of u's currently eligible owner chunks.

        Cover-set gating (§IV-A): owner chunks unlock once the eligible
        buffer reaches ``k_gate``.  Bootstrap exception: when the swarm
        holds zero non-owner mass anywhere (K-only ablation, no spray),
        the throttled window is permitted — someone must seed the first
        copies, exactly the owner-revealing sends pre-round obfuscation
        exists to remove (Fig. 4/6).
        """
        cfg = self.cfg
        K = cfg.chunks_per_update
        if self.phase == "bt" or not cfg.enable_gating:
            return np.arange(u * K, (u + 1) * K)
        kappa = cfg.owner_throttle
        if self.nonowner[u] + kappa < cfg.k_gate and self.any_nonowner:
            return np.zeros(0, dtype=np.int64)  # gated: buffer too small
        # Per-sender de-synchronized rotation: a shared phase would make
        # every sender expose the SAME chunk index each slot, destroying
        # early chunk diversity (visible as a longer BT phase in Fig. 4).
        start = (self.slot * kappa + (u * 2654435761) % K) % K
        idx = (start + np.arange(kappa)) % K
        return u * K + idx

    def owner_windows(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized per-sender owner windows for the current slot.

        Returns ``(ids, starts, gated)``: ``ids`` is (n, kappa) global
        chunk ids of every sender's throttled rotation window, ``starts``
        the (n,) within-update offsets, and ``gated`` the (n,) mask of
        senders whose cover-set gate is closed (empty eligible window).
        Mirrors :meth:`eligible_owner_slice` for all senders at once so
        the batched slot engine never loops over clients; cached per
        (slot, phase) — ``nonowner`` only changes after transfers apply.
        """
        cfg = self.cfg
        K = cfg.chunks_per_update
        kappa = cfg.owner_throttle
        key = (self.slot, self.phase)
        if self._win_cache is not None and self._win_cache[0] == key:
            return self._win_cache[1:]
        u = np.arange(cfg.n, dtype=np.int64)
        starts = (self.slot * kappa + (u * 2654435761) % K) % K
        idx = (starts[:, None] + np.arange(kappa, dtype=np.int64)) % K
        ids = u[:, None] * K + idx
        gated = (self.nonowner + kappa < cfg.k_gate) & self.any_nonowner
        self._win_cache = (key, ids, starts, gated)
        return ids, starts, gated

    def eligible_supply(self, cand: np.ndarray,
                        rows: np.ndarray | None = None,
                        have_cols: np.ndarray | None = None) -> np.ndarray:
        """(len(rows), len(cand)) bool: may row-client serve chunk c?

        Built once per slot by the batched engine (and per receiver-
        neighborhood by max-flow); applies cover-set gating + owner
        throttling fully vectorized via :meth:`owner_windows`.
        ``have_cols`` lets a caller that already gathered
        ``have[:, cand]`` (all rows) share that buffer; in the ungated
        phases it is returned as-is, so callers must not mutate it.
        """
        cfg = self.cfg
        ungated = self.phase == "bt" or not cfg.enable_gating
        K = cfg.chunks_per_update
        kappa = cfg.owner_throttle
        if rows is None:
            # All-rows path: each candidate column has exactly ONE owner
            # row, so gating touches m cells — no (n, m) broadcast.
            sup = (np.take(self.have, cand, axis=1)
                   if have_cols is None else have_cols)
            if ungated:
                return sup
            if have_cols is not None:
                sup = sup.copy()
            cand_owner = self.owners[cand]
            _, starts, gated = self.owner_windows()
            off = cand - cand_owner * K
            # chunk c (offset in its update) is in its owner's rotation
            # window iff (offset - start_u) mod K < kappa, gate open.
            allowed = (((off - starts[cand_owner]) % K) < kappa)
            allowed &= ~gated[cand_owner]
            sup[cand_owner, np.arange(cand.size)] &= allowed
            return sup
        sup = self.have[np.ix_(rows, cand)]
        if ungated:
            return sup
        cand_owner = self.owners[cand]
        _, starts, gated = self.owner_windows()
        own = cand_owner[None, :] == rows[:, None]
        off = cand - cand_owner * K
        in_win = ((off[None, :] - starts[rows][:, None]) % K) < kappa
        allowed = in_win & ~gated[rows][:, None]
        sup &= (~own) | allowed
        return sup

    def candidate_columns(self, sactive: np.ndarray) -> np.ndarray:
        """Chunk ids any active sender could serve this slot (vectorized).

        Replicated chunks (some non-owner holds them) plus the open
        owner windows of ungated active senders; optionally capped to
        ``cand_cap`` columns for large-n runs, stratified across
        rarity bands so no replication level is starved.
        """
        cfg = self.cfg
        if self.phase == "bt" or not cfg.enable_gating:
            # Chunks already held by every client are needed nowhere, so
            # dropping them changes no schedule; the BT tail shrinks its
            # working set as the swarm completes.
            return np.flatnonzero(self.replicas < cfg.n)
        mask = self.replicas > 1
        ids, _, gated = self.owner_windows()
        ok = sactive & ~gated
        mask[ids[ok].ravel()] = True
        cand = np.flatnonzero(mask)
        cap = cfg.cand_cap
        if cap:
            # Rarity-stratified cap (jit-clean, branchless): the rarest
            # ``cap/2`` plus an even stride over the remaining
            # candidates.  A pure rarest-first cap starves large swarms
            # — the few holders of the rarest chunks saturate while the
            # plentiful mid-rarity supply sits outside the cap — so the
            # coverage half keeps every neighborhood servable.
            # Sentinel-padding the rarity keys up to ``cap`` entries
            # keeps argpartition legal for any cand size; when the cap
            # does not bind, the halves tile all of cand and np.sort
            # restores it exactly — schedules are unchanged either way.
            half = cap // 2
            pad = max(cap - cand.size, 0)
            key = np.concatenate([self.replicas[cand],
                                  np.full(pad, np.iinfo(np.int64).max)])
            sel = np.argpartition(key, half - 1)[:half]
            covered = np.zeros(key.size, dtype=bool)
            covered[sel] = True
            rest = np.flatnonzero(~covered)
            take = cap - half
            pos = (np.arange(take, dtype=np.int64)
                   * rest.size) // max(take, 1)
            sel = np.concatenate([sel, rest[pos]])
            sel = sel[sel < cand.size]
            cand = np.sort(cand[sel])
        return cand

    def eligible_row(self, u: int) -> np.ndarray:
        """Bool mask over all chunks that u may serve right now."""
        row = self.have[u].copy()
        K = self.cfg.chunks_per_update
        if self.phase != "bt" and self.cfg.enable_gating:
            row[u * K:(u + 1) * K] = False
            row[self.eligible_owner_slice(u)] = True
        return row

    def buffer_stats(self, u: int) -> tuple[int, int]:
        """(B_u, O_u): eligible buffer size and eligible owner count."""
        K = self.cfg.chunks_per_update
        if self.phase == "bt" or not self.cfg.enable_gating:
            return int(self.have[u].sum()), K
        o = len(self.eligible_owner_slice(u))
        return int(self.nonowner[u]) + o, o

    # -- transfer application -------------------------------------------
    def apply_transfers(self, snd: np.ndarray, rcv: np.ndarray,
                        chk: np.ndarray, phase_code: int,
                        consume_slot: bool = True,
                        t_start: np.ndarray | None = None,
                        t_end: np.ndarray | None = None):
        """Mark chunks delivered; update rarity, X_u and the event log.

        ``consume_slot=False`` applies the transfers without charging a
        round slot to ``per_slot_sent`` — used by the pre-round spray,
        which happens over ephemeral tunnels before slot 0.

        ``t_start``/``t_end`` (aligned with the input arrays) are the
        event engine's wall-clock stamps; they ride through the
        de-dup/reorder below so every *delivered* row keeps its instant.
        """
        if len(snd) == 0:
            if consume_slot:
                self.per_slot_sent.append(0)
            return
        snd = np.asarray(snd)
        rcv = np.asarray(rcv)
        chk = np.asarray(chk)
        # De-dup (receiver, chunk) within the slot (schedulers should
        # already avoid this, but enforce delivery-exactly-once).
        order = np.lexsort((chk, rcv))
        snd, rcv, chk = snd[order], rcv[order], chk[order]
        keep = np.ones(len(snd), dtype=bool)
        keep[1:] = ~((rcv[1:] == rcv[:-1]) & (chk[1:] == chk[:-1]))
        already = self.have[rcv, chk]
        keep &= ~already
        snd, rcv, chk = snd[keep], rcv[keep], chk[keep]
        if t_start is not None:
            t_start = np.asarray(t_start, np.float64)[order][keep]
            t_end = np.asarray(t_end, np.float64)[order][keep]

        # (B_u, O_u) at send time, vectorized (see buffer_stats):
        # ungated phases expose the whole inventory; gated warm-up
        # exposes X_u non-owner chunks plus the open kappa-window.
        K = self.cfg.chunks_per_update
        if self.phase == "bt" or not self.cfg.enable_gating:
            b = self.hold[snd].astype(np.int64)
            o = np.full(len(snd), K, dtype=np.int64)
        else:
            _, _, gated = self.owner_windows()
            o = np.where(gated[snd], 0, self.cfg.owner_throttle)
            o = o.astype(np.int64)
            b = self.nonowner[snd].astype(np.int64) + o

        self.have[rcv, chk] = True
        np.add.at(self.replicas, chk, 1)
        np.add.at(self.hold, rcv, 1)
        owner_mask = self.owners[chk] != rcv
        np.add.at(self.nonowner, rcv[owner_mask], 1)
        if owner_mask.any():
            self.any_nonowner = True
        self._win_cache = None    # gating state changed mid-slot

        self.log.append(self.slot, snd, rcv, chk, b, o, phase_code,
                        t_start=t_start, t_end=t_end)
        cnt = len(snd)
        if consume_slot:
            self.per_slot_sent.append(cnt)
        if phase_code == 1:
            self.warmup_sent += cnt
        elif phase_code == 2:
            self.bt_sent += cnt

    # -- progress queries -------------------------------------------------
    def holdings(self) -> np.ndarray:
        return self.hold.copy()

    def warmup_done(self) -> bool:
        """s_BT condition: every *active* client holds >= k_term chunks."""
        if not self.active.any():
            return True
        return bool((self.hold[self.active] >= self.cfg.k_term).all())

    def all_done(self) -> bool:
        if not self.active.any():
            return True
        return bool((self.hold[self.active] >= self.cfg.total_chunks).all())

    def reconstructable_sets(self) -> np.ndarray:
        """A_v^r as a bool matrix (n_clients, n_updates) at current slot."""
        n, K = self.cfg.n, self.cfg.chunks_per_update
        per_update = self.have.reshape(n, n, K)
        return per_update.all(axis=2)
