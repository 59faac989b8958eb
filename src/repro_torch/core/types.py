"""Core datatypes for FLTorrent (paper §II).

Conventions
-----------
* ``n`` clients, each producing one update of ``K`` chunks of ``C`` bytes
  (homogeneous update sizes, as assumed by the paper's analysis §II-B).
* Global chunk ids are ``owner * K + i`` for ``i in [0, K)``; the owner of
  chunk ``c`` is ``c // K``.  These are *analysis labels* — the wire
  protocol exchanges (descriptor-id, piece-index) which do not encode the
  owner, and attacks only ever see descriptor ids (see attacks.py).
* Time is slotted (Δ = 1 s by default).  Capacities are expressed in
  chunks/slot (paper §II-B: ``u_v = floor(U_v Δ / C)``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # pragma: no cover - annotation only
    from .policy import SchedulerPolicy  # noqa: F401


@dataclass(frozen=True)
class SwarmConfig:
    """Static configuration of one FLTorrent round (paper Table I)."""

    n: int = 100                 # number of clients |V|
    chunks_per_update: int = 206  # K (GoogLeNet default: 206 x 256 KiB)
    chunk_bytes: int = 256 * 1024  # C
    min_degree: int = 10         # m, overlay minimum degree
    extra_edge_frac: float = 0.1  # heterogeneous neighbor counts above m
    slot_seconds: float = 1.0    # Δ
    s_max: int = 1_000_000       # round deadline (slots); large default

    # --- warm-up knobs (paper §II-D, §III-B) ---
    # Termination threshold: warm-up ends when every active client holds
    # at least ``k_term`` chunks.  The paper reports it as K = percentage
    # of the swarm-wide chunk universe |C^r| = n*K (§V-A).
    warmup_threshold_pct: float = 0.10   # "K" in the paper's figures
    # Analysis / gating knob: an honest sender enables owner chunks only
    # once its eligible buffer reaches ``k_gate`` = ceil(alpha * K)
    # (paper §II-D uses alpha = 10% of a single update's chunk count).
    gate_alpha: float = 0.10
    owner_throttle: int = 1      # kappa_u (default 1, paper §IV-A)

    spray_ratio: float = 0.2     # R, pre-round obfuscation strength
    lag_slots: int = 3           # T_lag; lags ~ Unif{0..T_lag-1}
    tau_concurrent: int = 4      # tau, max distinct receivers per sender/slot

    # Feature toggles (for the paper's ablations, Fig. 4/6):
    enable_preround: bool = True     # PR
    enable_timelag: bool = True      # TL
    enable_gating: bool = True       # K (cover-set gating + throttle)
    enable_nonowner_first: bool = True

    # Warm-up scheduling policy: a name registered in core/policy.py
    # ("greedy_fastest_first", "random_fifo", "random_fastest_first",
    # "distributed", "flooding", or any plugin) or a SchedulerPolicy
    # instance — `cfg.replace(scheduler=MyPolicy())` round-trips.
    scheduler: "str | SchedulerPolicy" = "greedy_fastest_first"
    # Slot-engine implementation: "batched" resolves the per-slot
    # assignment with vectorized budgeted rounds over all receivers at
    # once (paper-scale swarms, default); "loop" is the reference
    # per-receiver engine both others are equivalence-tested against;
    # "jit" runs the same matching as fixed-shape jitted JAX kernels
    # over packed uint32 bitplanes (core/jit_engine.py) for n>=~500
    # scaling sweeps.  All three are legality- and parity-locked in
    # tests/test_scheduler_equivalence.py.
    scheduler_impl: str = "batched"
    seed: int = 0
    # Large-n performance knob: cap the per-slot candidate-chunk set
    # to ``cand_cap`` chunks, stratified across rarity bands so every
    # replication level stays represented (0 = exact).  The per-slot
    # budget (sum of downlinks) is far below the cap, so utilization
    # is essentially unchanged (validated at n=100).
    cand_cap: int = 0

    # ------------------------------------------------------------------
    @property
    def total_chunks(self) -> int:
        """|C^r| — the swarm-wide chunk universe."""
        return self.n * self.chunks_per_update

    @property
    def k_term(self) -> int:
        """Warm-up termination threshold in chunks (universe fraction)."""
        return int(np.ceil(self.warmup_threshold_pct * self.total_chunks))

    @property
    def k_gate(self) -> int:
        """Cover-set gating threshold (per-update fraction, §II-D)."""
        return int(np.ceil(self.gate_alpha * self.chunks_per_update))

    @property
    def spray_copies(self) -> int:
        """sigma = floor(R * K) chunks sprayed per source (§III-B.1)."""
        return int(np.floor(self.spray_ratio * self.chunks_per_update))

    def replace(self, **kw) -> "SwarmConfig":
        return dataclasses.replace(self, **kw)


@dataclass
class Transfer:
    """One observed chunk transmission (an event-log row)."""

    slot: int
    sender: int      # round pseudonym == client index within the round sim
    receiver: int
    chunk: int       # global chunk id
    owner: int       # ground-truth source (= chunk // K); hidden from attacks
    phase: str       # "spray" | "warmup" | "bt"
    # Eligible-buffer accounting at send time, for empirical bound checks:
    eligible_size: int = 0   # B_u
    eligible_owner: int = 0  # O_u


@dataclass
class RoundMetrics:
    """Aggregate outcome of one simulated round (paper §II-D, §V)."""

    t_warm: int = 0            # warm-up duration (slots)
    t_round: int = 0           # total round duration (slots)
    # Wall-clock round times (seconds).  The slot engine stamps the
    # slot grid (t = slots * Δ); the event engine (repro.net) reports
    # realized transport makespans + tracker control time, which is
    # what the paper's §V-E seconds claims are about.
    t_warm_s: float = 0.0      # spray + warm-up cycles + control time
    t_round_s: float = 0.0     # total realized round duration
    t_spray_s: float = 0.0     # pre-round obfuscation transport
    control_s: float = 0.0     # tracker control plane (directive RTTs)
    warmup_share_s: float = 0.0   # t_warm_s / t_round_s
    warmup_chunks_sent: int = 0
    bt_chunks_sent: int = 0
    warmup_utilization: float = 0.0   # Util(pi; H) during warm-up
    overall_utilization: float = 0.0
    warmup_share: float = 0.0         # t_warm / t_round
    failed_open: bool = False         # warm-up could not complete by s_max
    per_slot_warmup_util: np.ndarray | None = None
    active_at_deadline: np.ndarray | None = None  # bool (n,)

    def as_dict(self) -> dict:
        d = {k: v for k, v in dataclasses.asdict(self).items()
             if not isinstance(v, np.ndarray)}
        return d


def owner_of(chunk_ids: np.ndarray, chunks_per_update: int) -> np.ndarray:
    """Ground-truth source of each global chunk id."""
    return np.asarray(chunk_ids) // chunks_per_update


def chunk_range(owner: int, chunks_per_update: int) -> np.ndarray:
    return np.arange(owner * chunks_per_update, (owner + 1) * chunks_per_update)
