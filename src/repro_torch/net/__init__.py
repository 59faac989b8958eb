"""repro_torch.net — continuous-time event-driven transport (wall-clock
round times, max-min fair-share flows, tracker control plane).

The slot engines (:mod:`repro_torch.core.schedulers`) quantize time into
integer chunks-per-slot stages; this package is the real-valued
alternative behind ``RoundSimulator(time_engine="event")``:

* :mod:`repro_torch.net.fairshare` — progressive-filling max-min fair-share
  rate allocation over heterogeneous access links, vectorized over the
  active flow set, with pipelined per-chunk completion instants;
* :mod:`repro_torch.net.engine` — the :class:`EventEngine` transport of each
  directive cycle's scheduled transfers (same policies, same schedules,
  real seconds) and :class:`NetConfig`;
* :mod:`repro_torch.net.tracker` — the explicit tracker control plane:
  directive RTTs during warm-up, off the data path.

It exists for the paper's *time* claims (warm-up share, ~6-10% LLM
round-time overhead, bandwidth-optimality in seconds) and for the
timing side-channel surface (``t_start``/``t_end`` trace columns →
``repro_torch.core.attacks.timing_attribution``).
"""
from .engine import (DATACENTER_NET, RESIDENTIAL_NET, EventEngine,
                     NetConfig)
from .fairshare import FlowTimings, maxmin_rates, transport
from .tracker import TrackerControlPlane

__all__ = [
    "EventEngine", "NetConfig", "RESIDENTIAL_NET", "DATACENTER_NET",
    "FlowTimings", "maxmin_rates", "transport", "TrackerControlPlane",
]
