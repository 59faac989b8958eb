"""Access-link capacity models (paper §V-A, §V-E).

The paper samples heterogeneous uplink/downlink capacities from European
residential broadband statistics: uplink 15.5-25.3 Mbps and downlink
36.5-121 Mbps, i.e. roughly [7, 12] and [18, 60] chunks/s for 256 KiB
chunks.  LLM-scale stress tests instead use datacenter-class 7-10 Gbps
links (§V-E).

Two time domains consume these rates:

* the **slot engines** quantize to integer chunks/slot
  (:func:`quantize_rates`, paper §II-B: ``u_v = floor(U_v Δ / C)``) —
  the historical path;
* the **event engine** (:mod:`repro.net`) takes the raw bytes/s and
  never quantizes — transfer times are real-valued.

The slot-path ``max(1, floor(...))`` clamp guarantees liveness (a
zero-budget client could never finish a round), but when it binds it
silently *inflates* a slow uplink to a full chunk per slot — at small
``slot_seconds`` that can overstate slow-link throughput by orders of
magnitude.  :func:`quantize_rates` therefore warns when the clamp
binds; the event engine is the honest alternative.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np

MBPS = 1e6 / 8.0          # bytes/s per Mbps
GBPS = 1e9 / 8.0          # bytes/s per Gbps


def quantize_rates(
    up: np.ndarray,
    down: np.ndarray,
    chunk_bytes: int,
    slot_seconds: float,
    *,
    warn: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Raw bytes/s -> integer chunks/slot budgets (paper §II-B).

    The ``max(1, ...)`` liveness clamp is kept, but when it binds (some
    link moves less than one chunk per slot) the quantization is no
    longer faithful to the sampled rate — the slot engine will credit
    the link with up to ``chunk_bytes / (rate * slot_seconds)`` times
    its real throughput.  A ``RuntimeWarning`` flags it; runs that need
    honest slow links should use ``RoundSimulator(time_engine="event")``
    which consumes the raw rates.
    """
    uf = np.floor(np.asarray(up) * slot_seconds / chunk_bytes)
    df = np.floor(np.asarray(down) * slot_seconds / chunk_bytes)
    if warn:
        n_bind = int((uf < 1).sum() + (df < 1).sum())
        if n_bind:
            warnings.warn(
                f"chunks-per-slot clamp binds on {n_bind} link(s): "
                f"rate * slot_seconds < chunk_bytes, so the slot "
                f"engine inflates them to 1 chunk/slot; use "
                f"time_engine='event' (repro.net) for honest "
                f"slow-link timing",
                RuntimeWarning, stacklevel=2)
    u = np.maximum(1, uf).astype(np.int64)
    d = np.maximum(1, df).astype(np.int64)
    return u, d


@dataclass(frozen=True)
class LinkModel:
    """Uniform ranges for per-client up/down capacities in bytes/s."""

    up_lo: float
    up_hi: float
    down_lo: float
    down_hi: float

    def sample_rates(
        self,
        n: int,
        rng: np.random.Generator,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Per-client (uplink, downlink) raw rates in bytes/s.

        Draw order (all uplinks, then all downlinks) is part of the
        reproducibility contract: :meth:`sample_chunks_per_slot` is a
        quantizing wrapper over the same stream, so a slot run and an
        event run at the same seed see the same physical links.
        """
        up = rng.uniform(self.up_lo, self.up_hi, size=n)
        down = rng.uniform(self.down_lo, self.down_hi, size=n)
        return up, down

    def sample_chunks_per_slot(
        self,
        n: int,
        chunk_bytes: int,
        slot_seconds: float,
        rng: np.random.Generator,
        *,
        warn: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Per-client (uplink, downlink) budgets in chunks/slot (§II-B)."""
        up, down = self.sample_rates(n, rng)
        return quantize_rates(up, down, chunk_bytes, slot_seconds,
                              warn=warn)


@dataclass(frozen=True)
class StragglerLinkModel(LinkModel):
    """A :class:`LinkModel` with a slow-link straggler cohort.

    A ``straggler_frac`` Bernoulli subset of clients gets its uplink
    divided by ``up_slowdown`` (and downlink by ``down_slowdown``) —
    the bursty-residential regime where a few peers seed their update
    orders of magnitude slower than the swarm disseminates everyone
    else's.  Under synchronous deadlines these peers gate every round;
    under the async runner (fl/asyncfl.py) they deliver late and are
    down-weighted instead.

    Draw-order contract: the base draws come FIRST (identical to the
    parent model at the same seed), the straggler coin flips AFTER — so
    swapping a model for its straggler variant perturbs no downstream
    stream, and the non-straggler cohort keeps its exact base rates.
    """

    straggler_frac: float = 0.25
    up_slowdown: float = 8.0
    down_slowdown: float = 1.0

    def sample_rates(
        self,
        n: int,
        rng: np.random.Generator,
    ) -> tuple[np.ndarray, np.ndarray]:
        up, down = super().sample_rates(n, rng)
        slow = rng.random(n) < self.straggler_frac
        return (np.where(slow, up / self.up_slowdown, up),
                np.where(slow, down / self.down_slowdown, down))


# Paper defaults -------------------------------------------------------
RESIDENTIAL = LinkModel(
    up_lo=15.5 * MBPS, up_hi=25.3 * MBPS,
    down_lo=36.5 * MBPS, down_hi=121.0 * MBPS,
)

# Straggler-heavy residential: a quarter of the peers seed at 1/8 the
# uplink (asymmetric — upload is the scarce residential direction).
# The regime the async frontier (benchmarks/bench_async.py) measures.
RESIDENTIAL_STRAGGLER = StragglerLinkModel(
    up_lo=15.5 * MBPS, up_hi=25.3 * MBPS,
    down_lo=36.5 * MBPS, down_hi=121.0 * MBPS,
    straggler_frac=0.25, up_slowdown=8.0,
)

DATACENTER = LinkModel(      # LLM-scale stress tests (§V-E): 7-10 Gbps
    up_lo=7.0 * GBPS, up_hi=10.0 * GBPS,
    down_lo=7.0 * GBPS, down_hi=10.0 * GBPS,
)
