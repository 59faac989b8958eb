"""Typed columnar transfer trace — the observation half of the contract.

The scheduler family (§III-C) decides what a sender may legally *do* per
slot; the privacy evaluation (§IV-C) decides what an adversary may
legally *see*.  :class:`TransferTrace` is the seeing half: one typed
struct-of-arrays event record shared by the simulator, the multi-round
:class:`~repro.core.session.SwarmSession`, the attack suite, the
empirical privacy-bound checks, and the tracker audit — replacing the
untyped ``log: dict`` that used to be threaded through all of them.

Columns (equal-length numpy arrays)
-----------------------------------
``slot``       int32   stage index within the round (spray rows use 0)
``sender``     int32   round pseudonym; global peer id in session traces
``receiver``   int32   likewise
``chunk``      int64   round-local global chunk id (``owner_local*K+i``)
``owner``      int32   ground-truth source — scoring only, never a
                       protocol observable (attacks read ``desc()``)
``b_size``     int64   sender's eligible buffer B_u at send time (Eq. 1)
``o_size``     int64   eligible owner count O_u at send time (Eq. 1)
``phase``      int8    0 = spray, 1 = warm-up, 2 = BT
``round``      int32   session round index (0 for single-round traces)
``t_start``    float64 wall-clock start of the transfer (seconds)
``t_end``      float64 wall-clock completion instant (seconds)
``generation`` int32   model generation the payload belongs to; equals
                       ``round`` for on-time rows, lags it for the late
                       deliveries of the async runner (fl/asyncfl.py)
``staleness``  int32   ``delivery_round - generation`` (0 = on time)

The two time columns are the continuous-time observation surface the
event engine (:mod:`repro.net`) opens: per-transfer start/finish
instants over max-min fair-share flows, i.e. the network-layer timing
side-channel (``attacks.timing_attribution``).  The slot engine stamps
slot boundaries (``t_start = slot * Δ``, ``t_end = (slot+1) * Δ``), so
ordering by ``t_start`` is always consistent with slot order and every
existing consumer keeps working unchanged.

Views are cheap: slicing helpers (:meth:`rounds_slice`,
:meth:`phase_slice`, :meth:`observed_by`) return new traces over
sub-arrays, and :meth:`desc` maps piece ids to torrent *descriptor* ids
— the only identity an attacker ever sees (§IV-C).

Backwards compatibility: the trace implements the mapping protocol
(``trace["slot"]``, ``dict(trace)``), so legacy consumers of the raw
log dict keep working; :meth:`from_log` coerces either representation.

Write your own adversary in ~20 lines
-------------------------------------
::

    def latecomer(trace, observers, K):
        view = trace.observed_by(observers).phase_slice("warmup")
        # last descriptor seen from each sender pseudonym
        order = np.argsort(view.slot, kind="stable")
        snd, desc = view.sender[order], view.desc()[order]
        guesses = {int(s): int(d) for s, d in zip(snd, desc)}
        hits = [g == s for s, g in guesses.items()]
        return float(np.mean(hits)) if hits else 0.0

(see ``examples/custom_policy.py`` for the runnable version).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from collections.abc import Iterator, Sequence

import numpy as np

PHASE_CODES = {"spray": 0, "warmup": 1, "bt": 2}

_KEYS = ("slot", "sender", "receiver", "chunk", "owner",
         "b_size", "o_size", "phase", "round", "t_start", "t_end",
         "generation", "staleness")
_DTYPES = {"slot": np.int32, "sender": np.int32, "receiver": np.int32,
           "chunk": np.int64, "owner": np.int32, "b_size": np.int64,
           "o_size": np.int64, "phase": np.int8, "round": np.int32,
           "t_start": np.float64, "t_end": np.float64,
           "generation": np.int32, "staleness": np.int32}


def _empty_cols(n: int = 0) -> dict:
    return {k: np.zeros(n, dtype=_DTYPES[k]) for k in _KEYS}


@dataclass
class TransferTrace:
    """Struct-of-arrays transfer record (one row per delivered chunk)."""

    generation: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))
    staleness: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))
    slot: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    sender: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    receiver: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))
    chunk: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    owner: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    b_size: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    o_size: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    phase: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int8))
    round: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    t_start: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.float64))
    t_end: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.float64))
    K: int = 0          # chunks per update — the descriptor partition

    # -- construction --------------------------------------------------
    @classmethod
    def from_arrays(cls, *, K: int = 0, round_idx: int = 0,
                    slot_seconds: float = 1.0, **cols) -> "TransferTrace":
        n = len(cols["slot"]) if "slot" in cols else 0
        out = _empty_cols(n)
        for k, v in cols.items():
            out[k] = np.asarray(v)
        if "round" not in cols:
            out["round"] = np.full(n, round_idx, dtype=np.int32)
        if "t_start" not in cols:
            # Slot-boundary stamps: the slot engine's (and any legacy
            # log's) time columns are the slot grid in seconds.
            s = out["slot"].astype(np.float64) * slot_seconds
            out["t_start"] = s
            out["t_end"] = s + slot_seconds
        if "generation" not in cols:
            # Synchronous default: every row carries the model of its
            # own round, delivered on time.  The async session stamps
            # lagging generations (and staleness > 0) explicitly.
            out["generation"] = out["round"].astype(np.int32)
        if "staleness" not in cols:
            out["staleness"] = np.zeros(n, dtype=np.int32)
        return cls(K=K, **out)

    @classmethod
    def from_log(cls, log, K: int | None = None,
                 round_idx: int = 0) -> "TransferTrace":
        """Coerce a legacy log dict (or a trace) into a TransferTrace.

        Ground-truth ``owner`` is taken verbatim when present (so tests
        that corrupt it still exercise owner-independence) and derived
        from ``chunk // K`` otherwise.
        """
        if isinstance(log, cls):
            if K is not None and K != log.K:
                return replace(log, K=int(K))
            return log
        cols = {k: np.asarray(log[k]) for k in _KEYS
                if k in log and len(np.asarray(log[k]).shape) == 1}
        kk = int(K if K is not None else log.get("K", 0) or 0)
        if "owner" not in cols and kk:
            cols["owner"] = np.asarray(cols["chunk"]) // kk
        return cls.from_arrays(K=kk, round_idx=round_idx, **cols)

    @classmethod
    def concat(cls, traces: Sequence["TransferTrace"]) -> "TransferTrace":
        """Cross-round concatenation (each part keeps its ``round``)."""
        traces = [t for t in traces if len(t)]
        if not traces:
            return cls()
        K = max(t.K for t in traces)
        cols = {k: np.concatenate([getattr(t, k) for t in traces])
                for k in _KEYS}
        return cls(K=K, **cols)

    # -- mapping protocol (legacy dict consumers) ----------------------
    def __getitem__(self, key: str) -> np.ndarray:
        if key not in _KEYS:
            raise KeyError(key)
        return getattr(self, key)

    def keys(self) -> tuple:
        return _KEYS

    def __iter__(self) -> Iterator[str]:
        return iter(_KEYS)

    def __contains__(self, key) -> bool:
        return key in _KEYS

    def get(self, key, default=None):
        return getattr(self, key) if key in _KEYS else default

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in _KEYS}

    def __len__(self) -> int:
        return int(len(self.slot))

    @property
    def n_events(self) -> int:
        return len(self)

    # -- views ---------------------------------------------------------
    def select(self, mask: np.ndarray) -> "TransferTrace":
        return TransferTrace(
            K=self.K, **{k: getattr(self, k)[mask] for k in _KEYS})

    def phase_slice(self, phase) -> "TransferTrace":
        """Rows of one protocol phase (name or code)."""
        code = PHASE_CODES.get(phase, phase)
        return self.select(self.phase == code)

    def warmup(self) -> "TransferTrace":
        """The attack surface: §IV-C adversaries observe warm-up only."""
        return self.phase_slice("warmup")

    def rounds_slice(self, r) -> "TransferTrace":
        return self.select(np.isin(self.round, np.atleast_1d(r)))

    def rounds(self) -> np.ndarray:
        return np.unique(self.round)

    def observed_by(self, observers) -> "TransferTrace":
        """Observer masking: the sub-trace a (coalition of) corrupted
        receiver(s) legally sees — rows it received, nothing else."""
        return self.select(np.isin(self.receiver,
                                   np.asarray(observers)))

    # -- protocol-visible identities ------------------------------------
    def desc(self) -> np.ndarray:
        """Torrent descriptor id of each piece (``chunk // K``) — the
        identity attacks see; owner identities are never exposed."""
        if self.K <= 0:
            raise ValueError("TransferTrace.K not set; pass K to "
                             "from_log() for descriptor mapping")
        return self.chunk // self.K

    def desc_owner_lookup(self):
        """Ground-truth (round, descriptor) -> owner mapping for SCORING
        cross-round attacks (the per-round torrent re-keys descriptors,
        so guesses must be graded against each round's mapping).

        Returns ``grade(rounds, descs) -> owner`` vectorized; unknown
        pairs grade as -1 (never correct).
        """
        base = int(self.desc().max(initial=0)) + 1
        code = self.round.astype(np.int64) * base + self.desc()
        ucode, first = np.unique(code, return_index=True)
        uowner = self.owner[first].astype(np.int64)

        def grade(rounds: np.ndarray, descs: np.ndarray) -> np.ndarray:
            q = np.asarray(rounds, np.int64) * base + np.asarray(descs,
                                                                 np.int64)
            if ucode.size == 0:
                return np.full(q.shape, -1, dtype=np.int64)
            pos = np.clip(np.searchsorted(ucode, q), 0, len(ucode) - 1)
            return np.where(ucode[pos] == q, uowner[pos], -1)

        return grade

    # -- summaries -------------------------------------------------------
    def counts_by_phase(self) -> dict:
        return {name: int((self.phase == code).sum())
                for name, code in PHASE_CODES.items()}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"TransferTrace(n={len(self)}, K={self.K}, "
                f"rounds={len(self.rounds())}, {self.counts_by_phase()})")
