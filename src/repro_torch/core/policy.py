"""SchedulerPolicy plugin API — the scheduling half of the contract.

The paper's scheduler family (§III-C) and its privacy evaluation (§IV-C)
are two halves of one contract: what a sender may legally *do* per slot
and what an adversary may legally *see*.  This module is the doing half.
A :class:`SchedulerPolicy` turns a per-slot :class:`SlotView` into a
batch of transfers; the view encodes exactly what the policy may
observe:

* ``"full"``          — the tracker's centralized modes (§III-C.3-5):
  the complete eligible-supply matrix, per-sender.
* ``"neighborhood"``  — the distributed mode (§III-C.6): only the
  neighborhood-level availability union C^T A(v, s); requests may miss.
* ``"none"``          — flooding (§III-C.7): sender-local eligibility
  only, no receiver state at all.

Accessors on :class:`SlotView` are gated by the policy's declared
visibility; a ``"neighborhood"`` policy calling :meth:`SlotView.supply`
raises :class:`VisibilityError` — new network-layer attack/defense
pairs (UnlinkableDFL-style) plug in without being able to cheat.

Both slot engines (``SwarmConfig.scheduler_impl``: the paper-scale
``"batched"`` engine and the ``"loop"`` reference) sit *behind* this
protocol as interchangeable backends: a policy's :meth:`schedule` is
engine-agnostic, and the six built-in policies are equivalence-locked
byte-for-byte against the historical string dispatch
(``tests/golden_schedules.json``).

Registry: policies self-register under :data:`register_policy`;
``SwarmConfig.scheduler`` accepts a registered name *or* a policy
instance, so a new policy is one class — it works unchanged in
single-round (``simulate_round``), multi-round-churn (``SwarmSession``),
and figure-reproduction paths.

Write your own policy in ~20 lines
----------------------------------
::

    import numpy as np
    from repro_torch.core.policy import SchedulerPolicy, register_policy

    @register_policy
    class EagerMirror(SchedulerPolicy):
        '''Receivers request every missing chunk the neighborhood
        union advertises, from uniformly random neighbors.'''
        name = "eager_mirror"
        visibility = "neighborhood"

        def schedule(self, view):
            cand, union = view.availability_union()
            snd, rcv, chk = [], [], []
            for v in np.flatnonzero(view.receivers_open()):
                ids = np.flatnonzero(union[v])
                if ids.size == 0:
                    continue
                take = ids[:int(view.down[v])]
                nbr = np.flatnonzero(view.adj[v])
                tgt = view.rng.choice(nbr, size=take.size)
                ok = view.resolve_requests(tgt, cand[take])
                snd.append(tgt[ok]); chk.append(cand[take[ok]])
                rcv.append(np.full(int(ok.sum()), v, np.int64))
            if not snd:
                return view.empty()
            return (np.concatenate(snd), np.concatenate(rcv),
                    np.concatenate(chk))

    cfg = SwarmConfig(scheduler="eager_mirror")      # or an instance

(the runnable version lives in ``examples/custom_policy.py``).
"""
from __future__ import annotations

import numpy as np

VISIBILITY_FULL = "full"
VISIBILITY_NEIGHBORHOOD = "neighborhood"
VISIBILITY_NONE = "none"
_LEVELS = {VISIBILITY_NONE: 0, VISIBILITY_NEIGHBORHOOD: 1,
           VISIBILITY_FULL: 2}


class VisibilityError(PermissionError):
    """A policy touched state its declared visibility does not grant."""


def _empty():
    return (np.zeros(0, np.int64), np.zeros(0, np.int64),
            np.zeros(0, np.int64))


class SlotView:
    """What one scheduling policy may see of the swarm this slot.

    Wraps a :class:`~repro.core.state.SwarmState` and exposes it in
    three tiers.  *Ungated* protocol facts (topology, budgets, slot
    clock, activity, the shared rng stream) are visible to everyone —
    the tracker publishes them.  *Scoped* accessors are gated by the
    policy's declared visibility level and raise
    :class:`VisibilityError` when over-reached.  *Mechanics* accessors
    (:meth:`resolve_requests`, :meth:`my_eligible`) model the transfer
    medium / a sender's self-knowledge and are visibility-free: issuing
    a request that may miss is precisely the distributed mode's handicap
    (§III-C.6), not an observation.

    The six built-in backends additionally reach the raw state through
    :meth:`_engine_state` — an audited door for the equivalence-locked
    engine implementations (they are trusted to *use* only what their
    policy's visibility grants; the lock is the byte-identity test
    against the historical dispatch).  Plugin policies should use the
    scoped accessors instead.
    """

    def __init__(self, state, visibility: str = VISIBILITY_FULL):
        if visibility not in _LEVELS:
            raise ValueError(f"unknown visibility {visibility!r}")
        self._state = state
        self.visibility = visibility

    # -- ungated protocol facts ---------------------------------------
    @property
    def cfg(self):
        return self._state.cfg

    @property
    def rng(self) -> np.random.Generator:
        return self._state.rng

    @property
    def n(self) -> int:
        return self._state.cfg.n

    @property
    def slot(self) -> int:
        return self._state.slot

    @property
    def phase(self) -> str:
        return self._state.phase

    @property
    def adj(self) -> np.ndarray:
        return self._state.adj

    @property
    def active(self) -> np.ndarray:
        return self._state.active

    @property
    def up(self) -> np.ndarray:
        return self._state.up

    @property
    def down(self) -> np.ndarray:
        return self._state.down

    @property
    def hold(self) -> np.ndarray:
        """Per-client chunk counts (tracker-published progress)."""
        return self._state.hold

    def senders_active(self) -> np.ndarray:
        return self._state.senders_active()

    def receivers_open(self) -> np.ndarray:
        """Clients still requesting this slot: active, downlink left,
        and (during warm-up) below the k_term cover threshold."""
        st = self._state
        ok = st.active & (st.down > 0)
        if st.phase != "bt":
            ok = ok & (st.hold < st.cfg.k_term)
        return ok

    @staticmethod
    def empty():
        """The canonical empty transfer batch."""
        return _empty()

    # -- gating --------------------------------------------------------
    def _require(self, level: str, what: str):
        if _LEVELS[self.visibility] < _LEVELS[level]:
            raise VisibilityError(
                f"{what} requires visibility >= {level!r}; this policy "
                f"declared {self.visibility!r}")

    # -- full (centralized tracker view) -------------------------------
    def _engine_state(self):
        """Audited backend door: raw state for the built-in engines."""
        return self._state

    @property
    def state(self):
        """Raw swarm state — centralized (``"full"``) policies only."""
        self._require(VISIBILITY_FULL, "SlotView.state")
        return self._state

    def candidate_columns(self) -> np.ndarray:
        """Chunk ids any active sender could serve this slot."""
        self._require(VISIBILITY_FULL, "candidate_columns()")
        return self._state.candidate_columns(self._state.senders_active())

    def supply(self, cand: np.ndarray | None = None):
        """(cand, (n, len(cand)) bool): the full eligible-supply matrix
        — who can serve which candidate chunk, gating applied."""
        self._require(VISIBILITY_FULL, "supply()")
        st = self._state
        if cand is None:
            cand = st.candidate_columns(st.senders_active())
        return cand, st.eligible_supply(cand)

    # -- neighborhood (distributed announcements, §III-C.6) -------------
    def availability_union(self):
        """(cand, (n, m) bool): per-receiver neighborhood availability
        union C^T A(v, s) over *missing* chunks — the tracker never
        reveals which neighbor holds what."""
        self._require(VISIBILITY_NEIGHBORHOOD, "availability_union()")
        st = self._state
        cand = st.candidate_columns(st.senders_active())
        if cand.size == 0:
            return cand, np.zeros((self.n, 0), dtype=bool)
        sup = st.eligible_supply(cand)
        union = np.zeros((self.n, cand.size), dtype=bool)
        for u in range(self.n):
            row = sup[u]
            if row.any():
                union[st.adj[u]] |= row[None, :]
        union &= ~st.have[:, cand]
        return cand, union

    # -- mechanics (visibility-free) ------------------------------------
    def my_eligible(self, u: int) -> np.ndarray:
        """Sender u's own eligible buffer (self-knowledge)."""
        return self._state.eligible_row(int(u))

    def resolve_requests(self, senders: np.ndarray,
                         chunks: np.ndarray) -> np.ndarray:
        """Did each (sender, chunk) request land on a holder that may
        serve it?  Models the transfer medium: the requester learns the
        outcome, never the sender's inventory."""
        senders = np.asarray(senders, np.int64)
        chunks = np.asarray(chunks, np.int64)
        if senders.size == 0:
            return np.zeros(0, dtype=bool)
        ucand, cinv = np.unique(chunks, return_inverse=True)
        sup = self._state.eligible_supply(ucand)
        return sup[senders, cinv]


# ----------------------------------------------------------------------
# The policy protocol
# ----------------------------------------------------------------------

class SchedulerPolicy:
    """One slot-scheduling strategy (§III-C) as a pluggable class.

    Subclasses declare:

    * ``name``        — registry key (``SwarmConfig.scheduler`` string);
    * ``visibility``  — the :class:`SlotView` tier the policy's
      decisions may read (enforced by the view's scoped accessors);
    * ``phases``      — protocol phases the policy may drive
      (``"warmup"`` and/or ``"bt"``); the simulator refuses a policy
      outside its phase applicability;

    and implement :meth:`schedule`.  :meth:`reset` is called once per
    round before the first slot; per-round mutable state (e.g. the
    flooding pair memory) belongs to the instance and is re-created
    there — no caller-threaded dicts.
    """

    name: str = ""
    visibility: str = VISIBILITY_FULL
    phases: tuple = ("warmup",)

    # -- lifecycle -----------------------------------------------------
    def reset(self, cfg) -> None:
        """Per-round state reset (called before slot 0)."""

    def applies_to(self, phase: str) -> bool:
        return phase in self.phases

    # -- the contract ----------------------------------------------------
    def schedule(self, view: SlotView):
        """Return ``(senders, receivers, chunks)`` int64 arrays for this
        slot.  Budgets (uplink/downlink/tau) are the policy's duty; the
        state layer additionally enforces delivery-exactly-once."""
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"{type(self).__name__}(name={self.name!r}, "
                f"visibility={self.visibility!r}, phases={self.phases})")


# ----------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------

_REGISTRY: dict[str, type] = {}


def register_policy(cls: type) -> type:
    """Class decorator: make ``cls`` resolvable by its ``name``."""
    if not issubclass(cls, SchedulerPolicy):
        raise TypeError(f"{cls!r} is not a SchedulerPolicy")
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a non-empty .name")
    _REGISTRY[cls.name] = cls
    return cls


def policy_names() -> tuple:
    return tuple(sorted(_REGISTRY))


def get_policy(spec) -> SchedulerPolicy:
    """Resolve ``SwarmConfig.scheduler`` to a policy instance.

    ``spec`` may be a registered name (fresh instance per call), a
    policy class, or an instance (returned as-is — the caller owns its
    lifecycle; the simulator resets it at every round start).
    """
    if isinstance(spec, SchedulerPolicy):
        return spec
    if isinstance(spec, type) and issubclass(spec, SchedulerPolicy):
        return spec()
    if isinstance(spec, str) and spec in _REGISTRY:
        return _REGISTRY[spec]()
    raise ValueError(
        f"unknown scheduler {spec!r}; registered: {policy_names()}")
