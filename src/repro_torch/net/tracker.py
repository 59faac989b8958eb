"""Tracker control plane in continuous time (repro_torch.net).

The slot world folds all coordination into the stage index; here the
tracker is an explicit control-plane participant: every warm-up
directive cycle costs one tracker round-trip (collect availability,
compute assignments, fan directives out) *before* any data moves, and
that time is pure coordination overhead — it occupies the wall clock
but no data-path bandwidth.  BT swarming is peer-driven (no per-stage
tracker involvement), so its stages pay no RTT; this asymmetry is
exactly the "FLTorrent adds ~6-10% round-time overhead over
BitTorrent-only" accounting the paper reports (§V-E): the privacy
warm-up is tracker-clocked, the swarm tail is not.

The control plane also keeps a directive ledger (cycle index, issue
instant, directive count) — the audit surface a commit-then-reveal
tracker would sign, and the timing ground truth for calibrating
side-channel experiments.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .. import obs


@dataclass
class TrackerControlPlane:
    """Per-round tracker coordination clock.

    ``rtt_s`` is the directive network round-trip per warm-up cycle
    (availability upload + directive fan-out); ``solve_s`` the
    centralized per-cycle assignment solve (negligible at K ~ 200
    pieces, seconds at LLM piece counts).  ``spray_setup_s`` is the
    one-off tunnel brokering cost of the pre-round obfuscation step
    (§III-B.1): the tracker hands every source its non-neighbor tunnel
    endpoints before any spray byte moves.
    """

    rtt_s: float = 0.1
    solve_s: float = 0.0
    spray_setup_s: float = 0.0
    cycles: list = field(default_factory=list)   # (slot, t_issue, n_dir)
    control_s: float = 0.0                       # total coordination time

    def directive_cycle(self, slot: int, t_now: float,
                        n_directives: int) -> float:
        """Charge one warm-up directive cycle; returns the instant data
        transfers may start (directives delivered)."""
        self.cycles.append((int(slot), float(t_now),
                            int(n_directives)))
        cost = self.rtt_s + self.solve_s
        self.control_s += cost
        rec = obs.get()
        if rec.enabled:
            rec.event("tracker.cycle", t=t_now, slot=int(slot),
                      n_directives=int(n_directives), cost_s=cost)
            rec.counter("tracker.control_s", cost)
        return t_now + cost

    def spray_setup(self, t_now: float, n_tunnels: int) -> float:
        """Charge the pre-round tunnel brokering; returns the spray
        start instant."""
        self.cycles.append((-1, float(t_now), int(n_tunnels)))
        self.control_s += self.spray_setup_s
        rec = obs.get()
        if rec.enabled:
            rec.event("tracker.spray_setup", t=t_now,
                      n_tunnels=int(n_tunnels),
                      cost_s=self.spray_setup_s)
            rec.counter("tracker.control_s", self.spray_setup_s)
        return t_now + self.spray_setup_s

    def as_log(self) -> dict:
        return {"rtt_s": self.rtt_s,
                "solve_s": self.solve_s,
                "spray_setup_s": self.spray_setup_s,
                "control_s": self.control_s,
                "n_cycles": len(self.cycles),
                "cycles": list(self.cycles)}
