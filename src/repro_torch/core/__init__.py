"""FLTorrent core — the paper's contribution, ported beside the JAX
package's ``core/``.

Public API (the JAX package's):

* ``SwarmConfig`` / ``simulate_round`` — one privacy-hardened
  dissemination round (spray -> warm-up -> BitTorrent -> deadline),
  on either time engine: the synchronous slot clock or the
  continuous-time event transport of :mod:`repro_torch.net`
  (``simulate_round(cfg, time_engine="event")`` — wall-clock seconds,
  fair-share flows solved in float64 on the GPU, or on the CPU with
  ``device="cpu"``; per-transfer ``t_start``/``t_end``).  The third
  slot engine, ``scheduler_impl="jit"`` (``jit_engine``), matches each
  slot over packed bitplanes on the GPU (hand CUDA kernels), or on the
  CPU with ``device="cpu"``.
* ``SwarmSession`` / ``ChurnModel`` — the persistent multi-round swarm:
  cross-round churn (leave/join/rejoin at round boundaries), evolving
  overlay with incremental edge repair, capacity persistence (§III-E).
* ``policy`` — the SchedulerPolicy plugin API: SlotView (visibility-
  scoped per-slot observation), register_policy/get_policy registry;
  ``SwarmConfig.scheduler`` accepts a name or an instance.
* ``schedulers`` — the §III-C family (RandomFIFO / RandomFastestFirst /
  GreedyFastestFirst / distributed / flooding + vanilla-BT) as
  registered policies over three interchangeable slot engines,
  ``loop``, ``batched`` and ``jit`` (+ max-flow stage upper bound).
* ``trace`` — typed columnar TransferTrace: the observation contract
  consumed by attacks/privacy/audit (round/phase slicing, observer
  masking, cross-round concatenation via ``SwarmSession.trace()``).
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
"""
from . import (aggregation, attacks, audit, bittorrent, byzantine,
               capacities, chunking, maxflow, overlay, policy, privacy,
               schedulers, session, simulator, state, trace, types)
from .policy import (SchedulerPolicy, SlotView, VisibilityError,
                     get_policy, policy_names, register_policy)
from .session import (ChurnModel, ChurnAwareSpray, SessionRound,
                      SprayPlan, SwarmSession)
from .simulator import RoundResult, RoundSimulator, simulate_round
from .trace import TransferTrace
from .types import RoundMetrics, SwarmConfig

__all__ = [
    "SwarmConfig", "RoundMetrics", "RoundSimulator", "RoundResult",
    "SwarmSession", "ChurnModel", "SessionRound",
    "SchedulerPolicy", "SlotView", "VisibilityError", "get_policy",
    "policy_names", "register_policy", "TransferTrace",
    "ChurnAwareSpray", "SprayPlan",
    "simulate_round", "aggregation", "attacks", "audit", "bittorrent",
    "byzantine", "capacities", "chunking", "maxflow", "overlay",
    "policy", "privacy", "schedulers", "session", "simulator", "state",
    "trace", "types",
]
