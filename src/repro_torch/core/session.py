"""SwarmSession: a persistent multi-round swarm with cross-round churn.

The paper's §III-E semantics — clients join and leave *between* rounds,
leavers rejoin at a later round boundary, and every round's aggregation
proceeds over whatever active set reconstructs — need state that
outlives a single :class:`~repro_torch.core.simulator.RoundSimulator`.  This
module carries that state:

* a **persistent peer population** with stable global ids: capacities
  are sampled once when a peer joins and stick for its lifetime,
* a **churn model** applied at round boundaries: Bernoulli leaves,
  Poisson joins of fresh peers, and planned rejoins ``rejoin_after``
  rounds later (the paper's rejoin-at-round-boundary rule),
* **incremental overlay evolution**: instead of re-rolling the whole
  graph every round, edges of departed peers go dormant, joiners attach
  with ``min_degree`` repair edges, and survivors whose active degree
  dropped get repair edges — so cross-round attack and privacy metrics
  (``edge_persistence``, ``pair_exposure``) can be computed against the
  topology as it actually *evolves*, which is what topology-dependent
  privacy bounds are a function of.

Usage
-----
::

    from repro_torch.core import SwarmConfig
    from repro_torch.core.session import ChurnModel, SwarmSession

    cfg = SwarmConfig(n=40, chunks_per_update=16, min_degree=5)
    ses = SwarmSession(cfg, churn=ChurnModel(leave_prob=0.1,
                                             join_rate=1.0,
                                             rejoin_after=2))
    for _ in range(10):
        rec = ses.next_round()
        rec.result.metrics          # RoundMetrics of this round's sub-swarm
        rec.active_ids              # local index i <-> global peer rec.active_ids[i]
    ses.edge_persistence()          # cross-round edge overlap in [0, 1]
    ses.pair_exposure().max()       # most-exposed neighbor pair (rounds)

Zero churn (the default, ``SwarmSession(cfg)``) reproduces today's
per-round ``simulate_round`` loop **bit-identically**: every round
re-rolls overlay and capacities from ``round_seed(r)`` exactly like
``RoundSimulator(cfg.replace(seed=round_seed(r)))`` — asserted
seed-for-seed in ``tests/test_session.py`` (the JAX package's) and
``tests/test_torch_session.py`` (this copy against it).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from collections.abc import Callable

import numpy as np

from .. import obs, resolve_device

from . import capacities as cap
from .overlay import _components, random_overlay
from .simulator import RoundResult, RoundSimulator
from .trace import TransferTrace
from .types import SwarmConfig


def _locate(ids: np.ndarray, g: np.ndarray):
    """Global -> local positions over the sorted active-id array;
    returns (positions, present-mask)."""
    g = np.asarray(g, np.int64)
    pos = np.searchsorted(ids, g)
    posc = np.minimum(pos, max(ids.size - 1, 0))
    ok = (pos < ids.size) & (ids.size > 0)
    if ids.size:
        ok &= ids[posc] == g
    return posc.astype(np.int64), ok


def _group_counts(gen: np.ndarray, owner: np.ndarray):
    """Yield (gen, owner, count) per distinct (generation, owner) pair."""
    key = np.asarray(gen, np.int64) * (2 ** 32) + np.asarray(owner,
                                                             np.int64)
    uk, cnt = np.unique(key, return_counts=True)
    for k, c in zip(uk, cnt):
        yield int(k >> 32), int(k & 0xFFFFFFFF), int(c)


@dataclass(frozen=True)
class ChurnModel:
    """Cross-round membership dynamics (paper §III-E).

    ``leave_prob``  — per-active-peer Bernoulli leave probability at each
    round boundary; ``join_rate`` — Poisson mean of *fresh* peers joining
    per boundary; ``rejoin_after`` — a leaver rejoins at the boundary
    this many rounds later (0 = leavers never come back).

    ``rejoin_dist`` selects the rejoin-delay law: ``"fixed"`` is the
    historical deterministic delay; ``"geometric"`` samples each
    leaver's delay from Geometric(1/rejoin_after) (mean
    ``rejoin_after``), modelling heterogeneous absence durations.
    ``participation()`` stays exact either way — it is computed from the
    realized membership history, not the delay law.
    """

    leave_prob: float = 0.0
    join_rate: float = 0.0
    rejoin_after: int = 2
    rejoin_dist: str = "fixed"      # "fixed" | "geometric"

    def __post_init__(self):
        if self.rejoin_dist not in ("fixed", "geometric"):
            raise ValueError(
                f"unknown rejoin_dist {self.rejoin_dist!r}")

    @property
    def enabled(self) -> bool:
        return self.leave_prob > 0.0 or self.join_rate > 0.0


@dataclass
class SprayPlan:
    """Explicit pre-round spray directives for one round (local ids).

    Produced by a :class:`SprayPolicy` at the round boundary and applied
    verbatim by the simulator's spray step.  ``fresh`` marks directives
    that open a NEW ephemeral tunnel (a true re-spray); unset rows reuse
    a tunnel that survived from an earlier round — the cost churn-aware
    budgeting saves.
    """

    src: np.ndarray                 # local source indices
    tgt: np.ndarray                 # local target indices (non-neighbors)
    offset: np.ndarray              # within-update chunk offsets
    fresh: np.ndarray               # bool: new tunnel vs reused

    def as_local_arrays(self):
        return (np.asarray(self.src, np.int64),
                np.asarray(self.tgt, np.int64),
                np.asarray(self.offset, np.int64))

    def fresh_counts(self, n: int) -> np.ndarray:
        """(n,) fresh-tunnel count per local source."""
        src = np.asarray(self.src, np.int64)
        return np.bincount(src[np.asarray(self.fresh, bool)], minlength=n)


class SprayPolicy:
    """Policy hook on :meth:`SwarmSession.begin_round`: decide what each
    source sprays this round.  Returning ``None`` keeps the historical
    full re-spray path (byte-identical; the simulator draws its own
    targets)."""

    def plan(self, session: "SwarmSession",
             ids: np.ndarray) -> SprayPlan | None:
        return None


class ChurnAwareSpray(SprayPolicy):
    """Churn-aware spray budgets (§III-B.1 under §III-E churn).

    The session tracks, per source, which sprayed chunk offsets still
    have a *live* tunnel: the holder is active and remains a
    non-neighbor of the source under the evolving overlay.  At every
    round boundary each active source re-sprays ONLY the offsets whose
    replication dropped below the per-offset target (holder left,
    dropped mid-round, or became a neighbor) — in particular a rejoiner
    re-sprays exactly the coverage it lost while absent — and reuses the
    surviving tunnels for the rest, so the per-round obfuscation mass
    (sigma chunks per source, Eq. 1's mixing input) is preserved while
    fresh tunnel setups shrink to the churn-induced delta.

    Requires an evolving-overlay session (``SwarmSession`` with churn or
    ``evolve_overlay=True``): tunnel validity is a statement about the
    persistent topology.
    """

    def __init__(self):
        # (n_peers, m) ledgers, -1 = dead slot; grown lazily with joins.
        self._offs: np.ndarray | None = None
        self._holds: np.ndarray | None = None

    def _grown(self, P: int, m: int):
        if self._offs is None:
            self._offs = np.full((P, m), -1, np.int64)
            self._holds = np.full((P, m), -1, np.int64)
        elif self._offs.shape[0] < P:
            pad = np.full((P - self._offs.shape[0], m), -1, np.int64)
            self._offs = np.vstack([self._offs, pad])
            self._holds = np.vstack([self._holds, pad])
        return self._offs, self._holds

    def plan(self, ses: "SwarmSession",
             ids: np.ndarray) -> SprayPlan | None:
        """Fully vectorized over the (source, tunnel-slot) ledger — no
        per-peer Python loop at the round boundary (the boundary is on
        the per-round critical path at paper-scale populations)."""
        if not ses.evolve:
            raise ValueError(
                "ChurnAwareSpray needs an evolving-overlay session "
                "(enable churn or evolve_overlay=True)")
        cfg = ses.cfg
        K = cfg.chunks_per_update
        m = min(cfg.spray_copies, K)
        if m == 0 or ids.size == 0:
            return None
        rng = ses.rng
        P = ses.n_peers
        all_offs, all_holds = self._grown(P, m)
        R = ids.size
        rr = np.arange(R)[:, None]
        offs = all_offs[ids]
        holds = all_holds[ids]
        # Tunnel survival: holder in this round's active set and still
        # a non-neighbor (overlay repair may have linked them).
        in_round = np.zeros(P, dtype=bool)
        in_round[ids] = True
        hsafe = np.clip(holds, 0, P - 1)
        valid = (holds >= 0) & in_round[hsafe] \
            & ~ses.adj[ids[:, None], hsafe]
        # Compact surviving tunnels to the front; invalid slots trail
        # and become the fresh re-spray positions.
        order = np.argsort(~valid, axis=1, kind="stable")
        offs, holds = offs[rr, order], holds[rr, order]
        keep = valid[rr, order]
        fresh_slot = ~keep
        # Fresh offsets: per row, distinct draws from the complement of
        # the kept offsets — kept keys pinned to +inf, row-sorted, the
        # j-th fresh slot takes the j-th cheapest complement offset.
        keys = rng.random((R, K))
        rk, ck = np.nonzero(keep)
        keys[rk, offs[rk, ck]] = np.inf
        oorder = np.argsort(keys, axis=1)
        j = np.cumsum(fresh_slot, axis=1) - 1
        offs = np.where(fresh_slot, oorder[rr, np.clip(j, 0, K - 1)],
                        offs)
        # Fresh targets: one uniform active non-neighbor per fresh slot
        # (rank-pick into the stable-sorted non-neighbor columns, the
        # RoundSimulator._spray technique).
        nn = ~ses.adj[np.ix_(ids, ids)]
        nn[np.arange(R), np.arange(R)] = False
        cnt = nn.sum(axis=1)
        can = cnt > 0
        torder = np.argsort(~nn, axis=1, kind="stable")
        pick = (rng.random((R, m))
                * np.maximum(cnt, 1)[:, None]).astype(np.int64)
        tglob = ids[torder[rr, pick]]
        holds = np.where(fresh_slot & can[:, None], tglob, holds)
        live = keep | (fresh_slot & can[:, None])
        all_offs[ids] = np.where(live, offs, -1)
        all_holds[ids] = np.where(live, holds, -1)
        rsel, csel = np.nonzero(live)
        if rsel.size == 0:
            return None
        return SprayPlan(src=rsel.astype(np.int64),
                         tgt=np.searchsorted(ids, holds[rsel, csel]),
                         offset=offs[rsel, csel],
                         fresh=fresh_slot[rsel, csel])


@dataclass
class SessionRound:
    """One session round: the sub-swarm result plus membership events.

    ``active_ids`` maps the round simulator's local client indices to
    stable global peer ids (``local i <-> global active_ids[i]``); all
    event arrays hold global ids.
    """

    round_idx: int
    active_ids: np.ndarray
    result: RoundResult
    joined: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    left: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    rejoined: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    dropped_midround: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    spray_plan: SprayPlan | None = None
    # Async deliveries (fl/asyncfl.py; empty on sync rounds):
    late_log: TransferTrace | None = None   # late rows, global ids
    drain_s: float = 0.0                    # boundary drain wall time
    late_ready: list = field(default_factory=list)   # (gen, owner) done
    dead_updates: list = field(default_factory=list)  # (gen, owner) lost

    @property
    def t_warm_s(self) -> float:
        """Wall-clock warm-up duration (spray + cycles + control)."""
        return self.result.metrics.t_warm_s

    @property
    def t_round_s(self) -> float:
        return self.result.metrics.t_round_s

    @property
    def warmup_share_s(self) -> float:
        return self.result.metrics.warmup_share_s

    def global_log(self) -> TransferTrace:
        """The round's transfer trace with sender/receiver/owner re-keyed
        to global peer ids and the session ``round`` column stamped
        (chunk/descriptor ids stay local to the round's torrent;
        ``t_start``/``t_end`` stay round-relative — the ``round`` column
        is the cross-round clock)."""
        tr = self.result.log
        ids = self.active_ids
        n = len(tr)
        return TransferTrace(
            K=tr.K,
            slot=tr.slot,
            sender=ids[np.asarray(tr.sender, np.int64)].astype(np.int32),
            receiver=ids[np.asarray(tr.receiver,
                                    np.int64)].astype(np.int32),
            chunk=tr.chunk,
            owner=ids[np.asarray(tr.owner, np.int64)].astype(np.int32),
            b_size=tr.b_size, o_size=tr.o_size, phase=tr.phase,
            round=np.full(n, self.round_idx, dtype=np.int32),
            t_start=tr.t_start, t_end=tr.t_end,
            # A round's own rows always carry its own generation, on
            # time; late deliveries live in ``late_log``.
            generation=np.full(n, self.round_idx, dtype=np.int32),
            staleness=np.zeros(n, dtype=np.int32))


class SwarmSession:
    """Persistent peer population carried across FL rounds.

    Parameters
    ----------
    cfg : SwarmConfig
        Template round config; ``cfg.n`` is the *initial* population.
        Each round runs with ``n`` = current active count and
        ``seed = round_seed(r)``.
    churn_rate : float
        Shorthand for ``ChurnModel(leave_prob=churn_rate)`` —
        ``churn_rate=0`` is the exact single-round-loop back-compat mode.
    churn : ChurnModel, optional
        Full churn spec; overrides ``churn_rate``.
    round_seed : callable(int) -> int, optional
        Per-round seed schedule; defaults to ``cfg.seed * 1000 + r``
        (the convention ``fl/runner.py`` has always used).
    evolve_overlay : bool, optional
        Force incremental topology evolution on/off.  Default: evolve
        exactly when churn is enabled, so the zero-churn session stays
        bit-identical to the historical per-round re-roll.
    device : torch device, optional
        Where ``time_engine="event"`` rounds solve their fair shares:
        the GPU unless the caller names the CPU
        (:func:`repro_torch.resolve_device`; no GPU and no device
        raises).  The slot engine ignores it.
    """

    def __init__(self, cfg: SwarmConfig, *,
                 churn_rate: float = 0.0,
                 churn: ChurnModel | None = None,
                 link_model: cap.LinkModel = cap.RESIDENTIAL,
                 bt_mode: str = "auto",
                 round_seed: Callable[[int], int] | None = None,
                 evolve_overlay: bool | None = None,
                 spray_policy: SprayPolicy | None = None,
                 time_engine: str = "slot",
                 net=None,
                 device=None):
        if churn is None:
            churn = ChurnModel(leave_prob=float(churn_rate))
        self.cfg = cfg
        self.churn = churn
        self.link_model = link_model
        self.bt_mode = bt_mode
        self.spray_policy = spray_policy
        # Time engine (§repro_torch.net): "event" runs every round on the
        # continuous-time transport — wall-clock metrics (t_warm_s,
        # t_round_s, warmup_share_s) then persist across churn like
        # every other per-round metric.
        if time_engine not in ("slot", "event"):
            raise ValueError(f"unknown time_engine {time_engine!r}")
        self.time_engine = time_engine
        self.net = net
        # Torch device of every round's fair-share solves (event only).
        self.device = (resolve_device(device) if time_engine == "event"
                       else None)
        self.round_seed = (round_seed if round_seed is not None
                           else lambda r: cfg.seed * 1000 + r)
        self.evolve = (churn.enabled if evolve_overlay is None
                       else bool(evolve_overlay))
        # Session-level stream (churn + overlay evolution), independent
        # of the per-round simulator streams so adding churn never
        # perturbs the in-round schedules of unaffected rounds.
        self.rng = np.random.default_rng(np.random.SeedSequence(
            [int(cfg.seed), 0x5E5510]))

        self.n_peers = cfg.n
        self.active = np.ones(cfg.n, dtype=bool)
        self.rejoin_at = np.full(cfg.n, -1, dtype=np.int64)
        self.round_idx = 0
        self.history: list[SessionRound] = []
        self._pending: tuple | None = None   # begun-but-not-run round
        # Async state (fl/asyncfl.py): wall-clock start of each round
        # (offsets[r] -> round r; a trailing entry marks the session
        # end), the carry-mode backlog of undelivered tail transfers
        # (global-id arrays), and per-(gen, owner) outstanding-chunk
        # counts for late-completion bookkeeping.
        self.offsets: list[float] = [0.0]
        self._backlog: dict | None = None
        self._outstanding: dict[tuple[int, int], int] = {}
        # Relay-replan state (carry mode): (gen, chunk) -> global ids of
        # peers holding that chunk (grown by background deliveries), and
        # (gen, owner) -> that update's outstanding chunk ids (for GC).
        self._holders: dict[tuple[int, int], np.ndarray] = {}
        self._update_chunks: dict[tuple[int, int], np.ndarray] = {}

        if self.evolve:
            self.adj = random_overlay(cfg.n, cfg.min_degree,
                                      cfg.extra_edge_frac, self.rng)
            # Persist RAW rates alongside the quantized budgets: the
            # same draws feed both time domains (see capacities.py), so
            # swapping time_engine never perturbs the session streams.
            self.up_bps, self.down_bps = link_model.sample_rates(
                cfg.n, self.rng)
            self.up, self.down = cap.quantize_rates(
                self.up_bps, self.down_bps, cfg.chunk_bytes,
                cfg.slot_seconds, warn=(time_engine == "slot"))
            self._exposure = np.zeros((cfg.n, cfg.n), dtype=np.int64)
        else:
            self.adj = None
            self.up = self.down = None
            self.up_bps = self.down_bps = None
            self._exposure = None

    # -- membership (round boundaries) ----------------------------------
    @property
    def min_active(self) -> int:
        """Leave-clamp floor: a round needs min_degree+1 peers to mesh."""
        return self.cfg.min_degree + 1

    def _rejoin_delays(self, k: int) -> np.ndarray:
        """Per-leaver rejoin delay (rounds) under ``churn.rejoin_dist``.

        ``"fixed"`` keeps the historical deterministic delay (and draws
        nothing, so existing seeds are unperturbed); ``"geometric"``
        samples Geometric(1/rejoin_after), mean ``rejoin_after``.
        """
        ra = max(self.churn.rejoin_after, 1)
        if self.churn.rejoin_dist == "geometric":
            return self.rng.geometric(1.0 / ra, size=k).astype(np.int64)
        return np.full(k, ra, dtype=np.int64)

    def _step_membership(self, r: int):
        """Apply the churn model at the boundary before round ``r``."""
        rejoined = np.flatnonzero(self.rejoin_at == r)
        if rejoined.size:
            self.active[rejoined] = True
            self.rejoin_at[rejoined] = -1

        # Bernoulli leaves over peers active before this boundary (a
        # peer that just rejoined is exempt for one boundary).
        candidates = np.flatnonzero(self.active)
        candidates = np.setdiff1d(candidates, rejoined,
                                  assume_unique=True)
        leaving = candidates[self.rng.random(candidates.size)
                             < self.churn.leave_prob]
        # Clamp: never let the active count fall below the floor —
        # a leave may shrink the collective but must never block it.
        # (Mid-round drops may already have us below the floor, so cap
        # the cancellation at the whole leave set.)
        budget = int(self.active.sum()) - leaving.size - self.min_active
        if budget < 0:
            keep = self.rng.choice(leaving.size,
                                   size=min(-budget, leaving.size),
                                   replace=False)
            leaving = np.delete(leaving, keep)
        if leaving.size:
            self.active[leaving] = False
            if self.churn.rejoin_after > 0:
                self.rejoin_at[leaving] = r + self._rejoin_delays(
                    leaving.size)

        # Poisson fresh joins: new global ids, sticky capacities.
        n_new = (int(self.rng.poisson(self.churn.join_rate))
                 if self.churn.join_rate > 0 else 0)
        joined = np.arange(self.n_peers, self.n_peers + n_new,
                           dtype=np.int64)
        if n_new:
            self._grow(n_new)
        newly_active = np.concatenate([rejoined, joined])
        if self.evolve:
            self._repair_overlay(newly_active)
        return joined, leaving, rejoined

    def _grow(self, n_new: int):
        """Extend all per-peer arrays for ``n_new`` fresh joiners."""
        cfg = self.cfg
        old = self.n_peers
        self.n_peers += n_new
        self.active = np.concatenate(
            [self.active, np.ones(n_new, dtype=bool)])
        self.rejoin_at = np.concatenate(
            [self.rejoin_at, np.full(n_new, -1, dtype=np.int64)])
        if not self.evolve:
            # Re-roll mode samples overlay + capacities fresh each
            # round anyway; only the membership arrays persist.
            return
        ub, db = self.link_model.sample_rates(n_new, self.rng)
        u, d = cap.quantize_rates(ub, db, cfg.chunk_bytes,
                                  cfg.slot_seconds,
                                  warn=(self.time_engine == "slot"))
        self.up_bps = np.concatenate([self.up_bps, ub])
        self.down_bps = np.concatenate([self.down_bps, db])
        self.up = np.concatenate([self.up, u])
        self.down = np.concatenate([self.down, d])
        adj = np.zeros((self.n_peers, self.n_peers), dtype=bool)
        adj[:old, :old] = self.adj
        self.adj = adj
        exp = np.zeros((self.n_peers, self.n_peers), dtype=np.int64)
        exp[:old, :old] = self._exposure
        self._exposure = exp

    # -- incremental overlay evolution ----------------------------------
    def _attach(self, v: int, need: int, ids: np.ndarray):
        """Add ``need`` edges from ``v`` to random active non-neighbors."""
        cands = ids[~self.adj[v, ids]]
        cands = cands[cands != v]
        if cands.size == 0 or need <= 0:
            return
        pick = self.rng.choice(cands, size=min(need, cands.size),
                               replace=False)
        self.adj[v, pick] = True
        self.adj[pick, v] = True

    def _repair_overlay(self, newly_active: np.ndarray):
        """Incremental edge repair instead of a full per-round re-roll.

        Joiners/rejoiners attach up to ``min_degree`` edges (rejoiners
        keep whatever edges survived); survivors whose *active* degree
        fell below ``min_degree`` get repair edges; finally the active
        subgraph is re-connected if churn split it.  Dormant edges of
        inactive peers are retained for their possible rejoin.
        """
        m = self.cfg.min_degree
        ids = np.flatnonzero(self.active)
        if ids.size <= 1:
            return
        for v in newly_active:
            deg = int(self.adj[v, ids].sum())
            self._attach(int(v), m - deg, ids)
        # Survivors under-degreed because their neighbors left.
        deg_active = self.adj[np.ix_(ids, ids)].sum(axis=1)
        for v in ids[deg_active < min(m, ids.size - 1)]:
            deg = int(self.adj[v, ids].sum())
            self._attach(int(v), m - deg, ids)
        # Heterogeneous extras for fresh joiners (mirrors the full
        # generator's extra_edge_frac so degree spread survives churn).
        n_extra = int(self.cfg.extra_edge_frac * newly_active.size * m / 2)
        for _ in range(n_extra):
            v = int(self.rng.choice(newly_active))
            self._attach(v, 1, ids)
        # Churn can disconnect the active subgraph; bridge components.
        sub = self.adj[np.ix_(ids, ids)]
        comp = _components(sub)
        while comp.max() > 0:
            a = int(self.rng.choice(np.flatnonzero(comp == 0)))
            b = int(self.rng.choice(np.flatnonzero(comp != 0)))
            ga, gb = int(ids[a]), int(ids[b])
            self.adj[ga, gb] = self.adj[gb, ga] = True
            sub = self.adj[np.ix_(ids, ids)]
            comp = _components(sub)

    # -- round execution -------------------------------------------------
    def begin_round(self) -> np.ndarray:
        """Apply boundary churn for the upcoming round; return the
        round's active set as global peer ids (ascending — local client
        index ``i`` of the round maps to ``ids[i]``).

        Splitting the boundary from the dissemination lets a caller (the
        FL runner) decide *who trains* before the round runs: rejoiners
        re-download the current model here, absent clients sit out.
        Idempotent until :meth:`run_round` consumes the begun round.
        """
        if self._pending is None:
            r = self.round_idx
            joined = left = rejoined = np.zeros(0, dtype=np.int64)
            if r > 0 and self.churn.enabled:
                joined, left, rejoined = self._step_membership(r)
            ids = np.flatnonzero(self.active)
            # Spray-policy hook: with the boundary applied, the policy
            # decides what each source sprays (churn-aware budgets);
            # None keeps the simulator's full re-spray byte-identical.
            plan = (self.spray_policy.plan(self, ids)
                    if self.spray_policy is not None else None)
            self._pending = (r, ids, joined, left, rejoined, plan)
        return self._pending[1]

    def next_round(self, **kw) -> SessionRound:
        """Advance membership (boundary churn) and run one round."""
        self.begin_round()
        return self.run_round(**kw)

    def run_round(self, *, dropouts: dict | None = None,
                  byzantine=None,
                  collect_maxflow: bool = False,
                  quorum_k: int | None = None,
                  tail_mode: str = "none",
                  bt_budget: int | None = None) -> SessionRound:
        """Run the dissemination round begun by :meth:`begin_round`.

        ``quorum_k``/``tail_mode``/``bt_budget`` are the async hooks
        (fl/asyncfl.py): a FedBuff quorum cuts the BT phase once
        ``quorum_k`` updates are swarm-complete (or after ``bt_budget``
        directive cycles — the deadline whose *masking* the async
        runner removes), and the undelivered tail is either drained at
        the boundary (``"drain"``, serialized wall clock) or carried as
        background flows into the NEXT round's event engine
        (``"carry"``, overlapped dissemination).  The defaults leave the
        sync path byte-identical.
        """
        self.begin_round()
        r, ids, joined, left, rejoined, plan = self._pending
        self._pending = None
        orec = obs.get()
        if orec.enabled:
            # Rows recorded inside this round carry the session round
            # index and land on the session wall clock (offsets[r]).
            orec.set_ctx(round=int(r))
            orec.time_base = float(self.offsets[-1])
            orec.event("session.round_start", t=0.0,
                       active=int(ids.size), joined=int(joined.size),
                       left=int(left.size), rejoined=int(rejoined.size),
                       population=int(self.n_peers))
        background, bmeta, dead_updates = self._map_backlog(r, ids,
                                                            tail_mode)
        if orec.enabled and background is not None:
            orec.gauge("session.carry_backlog", int(background[0].size))
        cfg_r = self.cfg.replace(n=int(ids.size),
                                 seed=int(self.round_seed(r)))
        if self.evolve:
            sub_adj = self.adj[np.ix_(ids, ids)]
            sim = RoundSimulator(
                cfg_r, self.link_model, dropouts=dropouts,
                byzantine=byzantine, bt_mode=self.bt_mode,
                overlay=sub_adj, up=self.up[ids], down=self.down[ids],
                up_bps=self.up_bps[ids], down_bps=self.down_bps[ids],
                rng=np.random.default_rng(cfg_r.seed),
                spray_plan=plan, time_engine=self.time_engine,
                net=self.net, background=background, device=self.device)
            self._exposure[np.ix_(ids, ids)] += sub_adj
        else:
            # Back-compat path: bit-identical to the historical
            # ``simulate_round(cfg.replace(seed=round_seed(r)))`` loop.
            sim = RoundSimulator(cfg_r, self.link_model,
                                 dropouts=dropouts, byzantine=byzantine,
                                 bt_mode=self.bt_mode, spray_plan=plan,
                                 time_engine=self.time_engine,
                                 net=self.net, background=background,
                                 device=self.device)
        res = sim.run(collect_maxflow=collect_maxflow,
                      quorum_k=quorum_k, tail_mode=tail_mode,
                      bt_budget=bt_budget)

        dropped = ids[~res.active]
        if self.evolve and dropped.size:
            # A mid-round dropout is a leave observed at the deadline:
            # it sits out and rejoins at a later round boundary.
            self.active[dropped] = False
            if self.churn.rejoin_after > 0:
                self.rejoin_at[dropped] = r + 1 + self._rejoin_delays(
                    dropped.size)
        rec = SessionRound(round_idx=r, active_ids=ids, result=res,
                           joined=joined, left=left, rejoined=rejoined,
                           dropped_midround=dropped, spray_plan=plan,
                           drain_s=res.drain_s)
        rec.dead_updates.extend(dead_updates)
        self._settle_async(rec, r, ids, res, bmeta, tail_mode)
        self.offsets.append(self.offsets[-1] + res.metrics.t_round_s
                            + res.drain_s)
        orec = obs.get()
        if orec.enabled:
            orec.event("session.round_end",
                       t=res.metrics.t_round_s + res.drain_s,
                       dropped_midround=int(dropped.size),
                       cut=bool(res.cut),
                       late_ready=len(rec.late_ready),
                       dead_updates=len(rec.dead_updates))
            orec.counter("session.rounds")
            orec.gauge("session.backlog_rows",
                       int(len(self._backlog["snd"]))
                       if self._backlog is not None else 0)
        self.history.append(rec)
        self.round_idx += 1
        return rec

    # -- async tail bookkeeping (fl/asyncfl.py) ---------------------------
    def _map_backlog(self, r: int, ids: np.ndarray, tail_mode: str):
        """Re-key the carry backlog from global ids to round-``r`` local
        ids and RE-PLAN every row's sender from the current holder set.

        A row whose RECEIVER departed is no longer needed (the absent
        peer re-syncs via the FL catch-up path on rejoin).  Senders are
        not fixed at extraction: each boundary every surviving row gets
        the least-loaded ACTIVE holder of its chunk — background
        deliveries grow the holder sets (:meth:`_settle_async`), so a
        chunk seeded once relays through fast peers in later rounds
        (exponential spread) instead of fanning out of its original
        holder forever.  An update none of whose holders remain active
        is dead and reported."""
        if tail_mode != "carry" or self._backlog is None:
            return None, None, []
        b = self._backlog
        self._backlog = None
        lr, r_ok = _locate(ids, b["rcv"])
        # Receiver-departed entries shrink the outstanding counts: the
        # update completes over the peers still active.
        for g, o in zip(b["gen"][~r_ok], b["owner"][~r_ok]):
            key = (int(g), int(o))
            if key in self._outstanding:
                self._outstanding[key] -= 1
        keep = r_ok.copy()
        snd_local = np.zeros(len(keep), np.int64)
        # Per-holder service-time estimate: queued rows / uplink rate.
        # Without the rate term a straggler uplink (32x slower) draws
        # the same share of rows as a fast peer and every update strands
        # a few rows behind it for an extra round.
        if self.up_bps is not None:
            inv_up = {int(v): 1.0 / float(self.up_bps[g])
                      for v, g in enumerate(ids)}
        else:
            inv_up = None
        load: dict[int, int] = {}
        hcache: dict[tuple[int, int], np.ndarray] = {}
        dead_set: set[tuple[int, int]] = set()
        for i in np.flatnonzero(keep):
            ckey = (int(b["gen"][i]), int(b["chunk"][i]))
            hs = hcache.get(ckey)
            if hs is None:
                hg = self._holders.get(ckey)
                if hg is None:
                    hs = np.zeros(0, np.int64)
                else:
                    lp, ok = _locate(ids, hg)
                    hs = lp[ok]
                hcache[ckey] = hs
            if hs.size == 0:
                dead_set.add((int(b["gen"][i]), int(b["owner"][i])))
                keep[i] = False
                continue
            # Least-finish-time active holder, ties to the lowest local
            # id — deterministic, and balances scarce-chunk fan-out
            # across the holder set as it grows.
            if inv_up is not None:
                best = int(min(hs, key=lambda v: (
                    (load.get(int(v), 0) + 1) * inv_up[int(v)], int(v))))
            else:
                best = int(min(hs, key=lambda v: (load.get(int(v), 0),
                                                  int(v))))
            load[best] = load.get(best, 0) + 1
            snd_local[i] = best
        dead = []
        if dead_set:
            for i in np.flatnonzero(keep):
                if (int(b["gen"][i]), int(b["owner"][i])) in dead_set:
                    keep[i] = False
            for key in dead_set:
                if self._outstanding.pop(key, None) is not None:
                    dead.append(key)
                self._gc_update(key)
        if not keep.any():
            return None, None, dead
        bmeta = {k: v[keep] for k, v in b.items()}
        bmeta["snd"] = ids[snd_local[keep]]
        # Queue order is delivery priority (per-flow pipelines follow
        # it): oldest generation first, then OWNER-MAJOR within a
        # generation — completing one update everywhere before starting
        # the next turns "87% of every update delivered" (zero merges)
        # into "87% of updates delivered completely" (staleness-1
        # merges).
        order = np.lexsort((bmeta["chunk"], bmeta["owner"],
                            bmeta["gen"]))
        bmeta = {k: v[order] for k, v in bmeta.items()}
        background = (snd_local[keep][order], lr[keep][order],
                      np.arange(order.size, dtype=np.int64))
        return background, bmeta, dead

    def _gc_update(self, key: tuple[int, int]):
        """Drop the holder-tracking state of a finished/dead update."""
        gen = key[0]
        for c in np.asarray(self._update_chunks.pop(key, ()), np.int64):
            self._holders.pop((gen, int(c)), None)

    def _settle_async(self, rec: SessionRound, r: int, ids: np.ndarray,
                      res: RoundResult, bmeta: dict | None,
                      tail_mode: str):
        """Assemble the round's late-delivery trace, update outstanding
        counts, queue the fresh tail, and mark newly-complete updates."""
        K = self.cfg.chunks_per_update
        delivered: list[tuple[int, int]] = []
        if tail_mode == "drain" and res.late is not None:
            la = res.late
            n = len(la["snd"])
            gen = np.full(n, r, dtype=np.int32)
            # Boundary-drain rows belong to the NEXT round's timeline at
            # negative offsets: wall time = offsets[r+1] + t, with
            # t in [-drain_s, 0] — strictly before round r+1's own rows.
            rec.late_log = TransferTrace.from_arrays(
                K=K, slot=la["slot"].astype(np.int32),
                sender=ids[la["snd"]].astype(np.int32),
                receiver=ids[la["rcv"]].astype(np.int32),
                chunk=la["chunk"],
                owner=ids[la["chunk"] // K].astype(np.int32),
                b_size=np.zeros(n, np.int64), o_size=np.zeros(n, np.int64),
                phase=np.full(n, 2, dtype=np.int8),
                round=np.full(n, r + 1, dtype=np.int32),
                t_start=la["t_start"] - res.drain_s,
                t_end=la["t_end"] - res.drain_s,
                generation=gen, staleness=np.ones(n, dtype=np.int32))
            delivered = [(r, int(o))
                         for o in np.unique(ids[la["chunk"] // K])]
        if tail_mode == "carry":
            if bmeta is not None and res.bg_delivered is not None \
                    and len(res.bg_delivered["meta"]):
                d = res.bg_delivered
                mi = np.asarray(d["meta"], np.int64)
                n = mi.size
                gen = bmeta["gen"][mi].astype(np.int32)
                rec.late_log = TransferTrace.from_arrays(
                    K=K, slot=np.zeros(n, np.int32),
                    sender=bmeta["snd"][mi].astype(np.int32),
                    receiver=bmeta["rcv"][mi].astype(np.int32),
                    chunk=bmeta["chunk"][mi],
                    owner=bmeta["owner"][mi].astype(np.int32),
                    b_size=np.zeros(n, np.int64),
                    o_size=np.zeros(n, np.int64),
                    phase=np.full(n, 2, dtype=np.int8),
                    round=np.full(n, r, dtype=np.int32),
                    t_start=d["t_start"], t_end=d["t_end"],
                    generation=gen,
                    staleness=(r - gen).astype(np.int32))
                for g, o, c in _group_counts(bmeta["gen"][mi],
                                             bmeta["owner"][mi]):
                    key = (g, o)
                    left_n = self._outstanding.get(key)
                    if left_n is None:
                        continue
                    self._outstanding[key] = left_n - c
                # Delivered receivers become holders: the relay replanner
                # picks them as senders at the next boundary.
                for g, c2 in sorted({(int(g_), int(c_)) for g_, c_ in
                                     zip(bmeta["gen"][mi],
                                         bmeta["chunk"][mi])}):
                    got = bmeta["rcv"][mi][
                        (bmeta["gen"][mi] == g)
                        & (bmeta["chunk"][mi] == c2)]
                    old = self._holders.get((g, c2))
                    if old is not None:
                        self._holders[(g, c2)] = np.union1d(old, got)
            # Requeue the survivors plus this round's fresh tail (older
            # generations first: queue order is pipeline priority).
            parts = []
            if bmeta is not None and res.bg_remaining is not None \
                    and res.bg_remaining.size:
                rm = np.asarray(res.bg_remaining, np.int64)
                parts.append({k: v[rm] for k, v in bmeta.items()})
            if res.tail is not None:
                t = res.tail
                for o in np.asarray(t["dead_owners"], np.int64):
                    rec.dead_updates.append((r, int(ids[o])))
                nt = len(t["snd"])
                if nt:
                    owner_g = ids[t["chunk"] // K]
                    parts.append({"snd": ids[t["snd"]],
                                  "rcv": ids[t["rcv"]],
                                  "chunk": t["chunk"],
                                  "owner": owner_g,
                                  "gen": np.full(nt, r, dtype=np.int64)})
                    for g, o, c in _group_counts(
                            np.full(nt, r, dtype=np.int64), owner_g):
                        self._outstanding[(g, o)] = \
                            self._outstanding.get((g, o), 0) + c
                    # Seed the relay state with cut-time holder sets.
                    ucols = np.asarray(t["ucols"], np.int64)
                    hmask = t["holder_mask"]
                    for j, c2 in enumerate(ucols):
                        self._holders[(r, int(c2))] = ids[hmask[:, j]]
                    uown = np.unique(ids[ucols // K])
                    for o in uown:
                        self._update_chunks[(r, int(o))] = \
                            ucols[ids[ucols // K] == o]
            if parts:
                self._backlog = {k: np.concatenate([p[k] for p in parts])
                                 for k in ("snd", "rcv", "chunk",
                                           "owner", "gen")}
            # Updates whose last outstanding chunk landed this round are
            # ready for the round-r merge (staleness r - gen > 0).
            done = [k for k, v in self._outstanding.items() if v <= 0]
            for k in done:
                del self._outstanding[k]
                self._gc_update(k)
            rec.late_ready.extend(done)
        elif tail_mode == "drain":
            if res.tail is not None:
                for o in np.asarray(res.tail["dead_owners"], np.int64):
                    rec.dead_updates.append((r, int(ids[o])))
            rec.late_ready.extend(delivered)

    # -- cross-round wall clock (async) -----------------------------------
    def wall_trace(self, include_late: bool = True) -> TransferTrace:
        """The session trace on ONE wall clock: every row's time columns
        shifted by its round's start offset, so cross-round orderings
        (overlap, boundary drains) are directly comparable."""
        parts = [rec.global_log() for rec in self.history]
        if include_late:
            parts += [rec.late_log for rec in self.history
                      if rec.late_log is not None]
        tr = TransferTrace.concat([p for p in parts if len(p)])
        if not len(tr):
            return tr
        S = np.asarray(self.offsets, np.float64)
        shift = S[np.minimum(tr.round, len(S) - 1)]
        tr.t_start = tr.t_start + shift
        tr.t_end = tr.t_end + shift
        return tr

    def run(self, rounds: int, **kw) -> list[SessionRound]:
        return [self.next_round(**kw) for _ in range(rounds)]

    # -- cross-round observation surface ---------------------------------
    def trace(self, include_late: bool = False) -> TransferTrace:
        """The session-wide :class:`TransferTrace`: every round's log in
        global peer ids with the ``round`` column stamped — the input
        cross-round adversaries (``attacks.persistent_neighbor_linkage``)
        consume together with :meth:`pair_exposure`.

        ``include_late`` appends the async late-delivery rows
        (generation < round, staleness > 0).  They keep their
        round-local chunk ids, so descriptor-keyed grading
        (``desc_owner_lookup``) over a mixed trace should use
        :func:`repro_torch.fl.asyncfl.adversary_view`, which band-shifts late
        descriptors into a disjoint range per generation."""
        parts = [rec.global_log() for rec in self.history]
        if include_late:
            parts += [rec.late_log for rec in self.history
                      if rec.late_log is not None]
        return TransferTrace.concat(parts)

    # -- cross-round topology metrics (privacy §III-E) -------------------
    def _round_edges(self, rec: SessionRound) -> set:
        ids = rec.active_ids
        iu, iv = np.nonzero(np.triu(rec.result.adj, 1))
        return set(zip(ids[iu].tolist(), ids[iv].tolist()))

    def edge_persistence(self) -> float:
        """Mean Jaccard overlap of consecutive rounds' edge sets (global
        ids).  0 = fully re-rolled topology (today's per-round loop);
        1 = frozen topology.  The quantity topology-dependent privacy
        bounds grow with: persistent neighbor pairs accumulate linkable
        observations across rounds."""
        if len(self.history) < 2:
            return 0.0
        vals = []
        prev = self._round_edges(self.history[0])
        for rec in self.history[1:]:
            cur = self._round_edges(rec)
            union = len(prev | cur)
            vals.append(len(prev & cur) / union if union else 0.0)
            prev = cur
        return float(np.mean(vals))

    def pair_exposure(self) -> np.ndarray:
        """(n_peers, n_peers) count of rounds each pair was adjacent."""
        if self._exposure is not None:
            return self._exposure.copy()
        exp = np.zeros((self.n_peers, self.n_peers), dtype=np.int64)
        for rec in self.history:
            ids = rec.active_ids
            exp[np.ix_(ids, ids)] += rec.result.adj
        return exp

    def wall_clock(self) -> dict:
        """Per-round wall-clock metrics across churn (seconds).

        Keys: ``t_warm_s``, ``t_round_s``, ``warmup_share_s``,
        ``control_s`` — arrays of length ``len(history)``.  Under the
        slot engine these are the slot grid in seconds; under the event
        engine they are realized transport makespans plus tracker
        control time.
        """
        ms = [rec.result.metrics for rec in self.history]
        return {
            "t_warm_s": np.array([m.t_warm_s for m in ms]),
            "t_round_s": np.array([m.t_round_s for m in ms]),
            "warmup_share_s": np.array([m.warmup_share_s for m in ms]),
            "control_s": np.array([m.control_s for m in ms]),
        }

    def participation(self) -> np.ndarray:
        """Per-round active fraction relative to the current population."""
        return np.array([rec.active_ids.size
                         / max(1, self._pop_at(rec)) for rec in
                         self.history])

    def _pop_at(self, rec: SessionRound) -> int:
        joined_later = sum(r.joined.size for r in self.history
                           if r.round_idx > rec.round_idx)
        return self.n_peers - joined_later
