"""Recording summarizer behind ``python -m repro_torch.obs report``.

Everything here is computed FROM THE RECORDING ALONE — no simulator
state: per-round phase breakdown (warm-up share, spray, BT, control
plane), top-k slowest peers (last flow finish / busy seconds per
sending peer), and the async staleness distribution.  The acceptance
check is that the per-round numbers reproduce
``RoundMetrics.t_warm_s`` / ``t_round_s`` / ``warmup_share_s``.
"""
from __future__ import annotations

from collections import defaultdict


def _spans(rows, name):
    return [r for r in rows if r.get("kind") == "span"
            and r.get("name") == name and "t0" in r]


def summarize(rows: list[dict], top_k: int = 5) -> dict:
    """Digest materialized rows into a report dict."""
    meta = rows[0].get("meta", {}) if rows and \
        rows[0].get("kind") == "header" else {}

    # Per-round phase spans (round attr defaults to 0 for bare
    # single-round recordings outside a session).
    rounds: dict[int, dict] = {}
    for name in ("round.spray", "round.warmup", "round.bt",
                 "round.total"):
        for sp in _spans(rows, name):
            r = int(sp.get("round", 0))
            rounds.setdefault(r, {})[name] = sp
    per_round = {}
    for r, sps in sorted(rounds.items()):
        tot = sps.get("round.total")
        warm = sps.get("round.warmup")
        if tot is None:
            continue
        base = tot["t0"]
        t_round_s = tot["t1"] - base
        t_warm_s = (warm["t1"] - base) if warm is not None else 0.0
        spray = sps.get("round.spray")
        per_round[r] = {
            "t_warm_s": t_warm_s,
            "t_round_s": t_round_s,
            "t_spray_s": (spray["t1"] - base) if spray else 0.0,
            "warmup_share_s": (t_warm_s / t_round_s) if t_round_s
            else 0.0,
        }

    # Phase breakdown: total simulated seconds and (when measured)
    # host wall seconds per span name.
    phases: dict[str, dict] = {}
    for r in rows:
        if r.get("kind") != "span":
            continue
        ph = phases.setdefault(r["name"], {"count": 0, "sim_s": 0.0,
                                           "wall_s": 0.0})
        ph["count"] += 1
        if "t0" in r:
            ph["sim_s"] += r["t1"] - r["t0"]
        if "wall_s" in r:
            ph["wall_s"] += r["wall_s"]

    # Per-sender activity from the flow batches.
    busy = defaultdict(float)
    last_fin = defaultdict(float)
    n_flows = defaultdict(int)
    for r in rows:
        if r.get("kind") != "flows":
            continue
        for j in range(r["n"]):
            s, e = r["t_start"][j], r["t_end"][j]
            if e < s:
                continue
            p = int(r["src"][j])
            busy[p] += e - s
            last_fin[p] = max(last_fin[p], e)
            n_flows[p] += 1
    slowest = sorted(last_fin, key=lambda p: (-last_fin[p], p))[:top_k]
    top = [{"peer": p, "last_finish_s": last_fin[p],
            "busy_s": busy[p], "n_flows": n_flows[p]}
           for p in slowest]

    # Metrics registry.
    metrics = {r["name"]: r for r in rows if r.get("kind") == "metric"}
    control_s = metrics.get("tracker.control_s", {}).get("value", 0.0)
    stale = metrics.get("async.staleness", {}).get("values", [])
    stale_dist: dict[int, int] = {}
    for v in stale:
        stale_dist[int(v)] = stale_dist.get(int(v), 0) + 1

    totals = {
        "t_round_s": sum(v["t_round_s"] for v in per_round.values()),
        "t_warm_s": sum(v["t_warm_s"] for v in per_round.values()),
        "control_s": control_s,
    }
    totals["warmup_share_s"] = (totals["t_warm_s"] / totals["t_round_s"]
                                if totals["t_round_s"] else 0.0)
    return {
        "meta": meta,
        "n_rows": len(rows),
        "rounds": per_round,
        "totals": totals,
        "phases": phases,
        "slowest_peers": top,
        "staleness": stale_dist,
        "counters": {k: v.get("value") for k, v in metrics.items()
                     if v.get("metric") == "counter"},
        "gauges": {k: v.get("value") for k, v in metrics.items()
                   if v.get("metric") == "gauge"},
    }


def format_report(summary: dict) -> str:
    """Human-readable rendering of :func:`summarize`'s dict."""
    out = []
    t = summary["totals"]
    out.append(f"recording: {summary['n_rows']} rows, "
               f"{len(summary['rounds'])} round(s)")
    if summary["meta"]:
        out.append(f"meta: {summary['meta']}")
    out.append(f"total: t_round_s={t['t_round_s']:.3f}  "
               f"t_warm_s={t['t_warm_s']:.3f}  "
               f"warmup_share={t['warmup_share_s']:.3f}  "
               f"control_s={t['control_s']:.3f}")
    for r, v in summary["rounds"].items():
        out.append(f"  round {r}: t_warm_s={v['t_warm_s']:.3f}  "
                   f"t_round_s={v['t_round_s']:.3f}  "
                   f"share={v['warmup_share_s']:.3f}  "
                   f"spray_s={v['t_spray_s']:.3f}")
    if summary["phases"]:
        out.append("phase breakdown (simulated / host wall):")
        for name, ph in sorted(summary["phases"].items()):
            out.append(f"  {name:<24} x{ph['count']:<5} "
                       f"sim={ph['sim_s']:.3f}s wall={ph['wall_s']:.4f}s")
    if summary["slowest_peers"]:
        out.append("slowest peers (by last flow finish):")
        for e in summary["slowest_peers"]:
            out.append(f"  peer {e['peer']:<5} "
                       f"last_finish={e['last_finish_s']:.3f}s "
                       f"busy={e['busy_s']:.3f}s flows={e['n_flows']}")
    if summary["staleness"]:
        dist = ", ".join(f"{k}: {v}" for k, v in
                         sorted(summary["staleness"].items()))
        out.append(f"staleness distribution: {{{dist}}}")
    if summary["counters"]:
        out.append("counters:")
        for k, v in sorted(summary["counters"].items()):
            out.append(f"  {k} = {v:g}")
    return "\n".join(out)
