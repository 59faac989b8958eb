"""FLTorrent core — the paper's contribution, ported beside the JAX
package's ``core/``.

Public API (the JAX package's, minus the multi-round session):

* ``SwarmConfig`` / ``simulate_round`` — one privacy-hardened
  dissemination round (spray -> warm-up -> BitTorrent -> deadline) on
  the synchronous slot clock.  The continuous-time event engine
  (``time_engine="event"``) and the jitted slot engine
  (``scheduler_impl="jit"``) are not ported yet and raise
  ``NotImplementedError`` (ROADMAP.md queue 1).
* ``policy`` — the SchedulerPolicy plugin API: SlotView (visibility-
  scoped per-slot observation), register_policy/get_policy registry;
  ``SwarmConfig.scheduler`` accepts a name or an instance.
* ``schedulers`` — the §III-C family (RandomFIFO / RandomFastestFirst /
  GreedyFastestFirst / distributed / flooding + vanilla-BT) as
  registered policies over two interchangeable slot engines, ``loop``
  and ``batched`` (+ max-flow stage upper bound).
* ``trace`` — typed columnar TransferTrace: the observation contract
  consumed by attacks/privacy/audit.
* ``privacy`` — Eq. (1)-(5) unlinkability bounds + empirical checks.
* ``attacks`` — vectorized Sequential/Amount Greedy + Clustering, the
  cross-round persistent-neighbor linkage adversary, and the timing
  side-channel attribution; ASR metrics.
* ``aggregation`` — FedAvg over the reconstructable active set (the
  ``fedavg_reduce`` kernel on the card).
* ``chunking`` — update <-> chunks + torrent descriptors (torch).
* ``audit`` — commit-then-reveal tracker accountability.

The host-side modules are copies of the JAX package's, with the same
numpy rng streams, so a seed gives the same schedule byte for byte.
``SwarmSession``, ``ChurnModel``, ``SessionRound``, ``ChurnAwareSpray``
and ``SprayPlan`` come with ``session.py`` in a later slice.
"""
from . import (aggregation, attacks, audit, bittorrent, byzantine,
               capacities, chunking, maxflow, overlay, policy, privacy,
               schedulers, simulator, state, trace, types)
from .policy import (SchedulerPolicy, SlotView, VisibilityError,
                     get_policy, policy_names, register_policy)
from .simulator import RoundResult, RoundSimulator, simulate_round
from .trace import TransferTrace
from .types import RoundMetrics, SwarmConfig

__all__ = [
    "SwarmConfig", "RoundMetrics", "RoundSimulator", "RoundResult",
    "SchedulerPolicy", "SlotView", "VisibilityError", "get_policy",
    "policy_names", "register_policy", "TransferTrace",
    "simulate_round", "aggregation", "attacks", "audit", "bittorrent",
    "byzantine", "capacities", "chunking", "maxflow", "overlay",
    "policy", "privacy", "schedulers", "simulator", "state",
    "trace", "types",
]
