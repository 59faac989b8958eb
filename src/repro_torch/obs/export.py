"""Exporters: JSONL event log and Perfetto/chrome-tracing timeline.

The canonical on-disk form is JSONL — one JSON object per line, first
line a ``header`` row carrying the schema version and recorder meta,
then the recorded rows in sequence order, then one ``metric`` row per
registry entry (sorted by name).  ``validate_rows`` is a pure-python
schema check (no external jsonschema dependency) used by the tests and
the bench smoke gate.

``to_perfetto`` renders a recording as chrome-tracing JSON — load it at
https://ui.perfetto.dev (or chrome://tracing): pid 0 carries the round
phase spans, pid 1 one track per sending peer (warm-up vs BT vs carried
background vs spray flows, colored by category), pid 2 the tracker
control plane, with async merge/cut instants on the phase track.
"""
from __future__ import annotations

import json

import numpy as np

SCHEMA_VERSION = 1

_KINDS = ("header", "span", "event", "flows", "metric")
_FLOW_COLS = ("src", "dst", "t_start", "t_end")


def _jsonable(v):
    """Recursively convert numpy scalars/arrays for json.dumps."""
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


def to_jsonl_rows(rec) -> list[dict]:
    """Materialize a recorder as JSON-safe rows: header, events in
    sequence order, then the metrics registry (sorted by name)."""
    rows = [{"kind": "header", "version": SCHEMA_VERSION,
             "meta": _jsonable(rec.meta)}]
    rows.extend(_jsonable(r) for r in rec.rows)
    for name in sorted(rec.metrics):
        m = rec.metrics[name]
        rows.append({"kind": "metric", "name": name,
                     **_jsonable(m)})
    return rows


def write_jsonl(rec_or_rows, path) -> int:
    """Write a recorder (or pre-materialized rows) as JSONL; returns
    the row count."""
    rows = (rec_or_rows if isinstance(rec_or_rows, list)
            else to_jsonl_rows(rec_or_rows))
    with open(path, "w") as fh:
        for r in rows:
            fh.write(json.dumps(r) + "\n")
    return len(rows)


def read_jsonl(path) -> list[dict]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


# -- schema validation ---------------------------------------------------
def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _numlist(v) -> bool:
    return isinstance(v, list) and all(_num(x) for x in v)


def validate_rows(rows: list[dict]) -> list[str]:
    """Schema-check materialized rows; returns a list of violation
    strings (empty == valid)."""
    errs: list[str] = []

    def bad(i, msg):
        errs.append(f"row {i}: {msg}")

    if not rows:
        return ["empty recording (no header row)"]
    if rows[0].get("kind") != "header":
        errs.append("row 0: first row must be the header")
    for i, r in enumerate(rows):
        if not isinstance(r, dict):
            bad(i, "not an object")
            continue
        kind = r.get("kind")
        if kind not in _KINDS:
            bad(i, f"unknown kind {kind!r}")
            continue
        if kind == "header":
            if i != 0:
                bad(i, "header row not first")
            if not isinstance(r.get("version"), int):
                bad(i, "header.version must be an int")
            if not isinstance(r.get("meta", {}), dict):
                bad(i, "header.meta must be an object")
            continue
        if kind != "metric" and not isinstance(r.get("seq"), int):
            bad(i, f"{kind} row missing int seq")
        name = r.get("name")
        if kind != "flows" and not isinstance(name, str):
            bad(i, f"{kind} row missing str name")
        if kind == "span":
            has_t = ("t0" in r) or ("t1" in r)
            if has_t and not (_num(r.get("t0")) and _num(r.get("t1"))):
                bad(i, "span t0/t1 must both be numbers")
            elif has_t and r["t1"] < r["t0"]:
                bad(i, f"span {name!r}: t1 < t0")
            if "wall_s" in r and not _num(r["wall_s"]):
                bad(i, "span wall_s must be a number")
            if not has_t and "wall_s" not in r:
                bad(i, f"span {name!r} has neither t0/t1 nor wall_s")
        elif kind == "event":
            if "t" in r and not _num(r["t"]):
                bad(i, "event t must be a number")
        elif kind == "flows":
            if not isinstance(r.get("track"), str):
                bad(i, "flows row missing str track")
            n = r.get("n")
            cols = {k: r.get(k) for k in _FLOW_COLS}
            if any(not isinstance(c, list) for c in cols.values()):
                bad(i, "flows src/dst/t_start/t_end must be lists")
                continue
            if not isinstance(n, int) or any(len(c) != n
                                             for c in cols.values()):
                bad(i, "flows columns must align with n")
                continue
            if any(e < s for s, e in zip(cols["t_start"], cols["t_end"])
                   if _num(s) and _num(e)):
                bad(i, "flows t_end < t_start")
        elif kind == "metric":
            mt = r.get("metric")
            if mt not in ("counter", "gauge", "hist"):
                bad(i, f"unknown metric type {mt!r}")
            elif mt == "hist":
                if not _numlist(r.get("values")):
                    bad(i, "hist values must be a number list")
            elif not _num(r.get("value")):
                bad(i, f"{mt} value must be a number")
    return errs


# -- Perfetto / chrome-tracing -------------------------------------------
_PID_PHASES = 0
_PID_PEERS = 1
_PID_TRACKER = 2

_PROC_NAMES = {_PID_PHASES: "round phases",
               _PID_PEERS: "peers (sender tracks)",
               _PID_TRACKER: "tracker control plane"}


def _us(t: float) -> float:
    return float(t) * 1e6


def to_perfetto(rows: list[dict]) -> dict:
    """Render materialized rows as a chrome-tracing JSON object.

    Only rows with simulated-time anchors land on the timeline: spans
    with ``t0``/``t1``, events with ``t``, flow batches, and tracker
    cycles (rendered as control-plane slices of their ``cost_s``).
    """
    ev: list[dict] = []
    for pid, pname in _PROC_NAMES.items():
        ev.append({"ph": "M", "pid": pid, "name": "process_name",
                   "args": {"name": pname}})
    ev.append({"ph": "M", "pid": _PID_PHASES, "tid": 0,
               "name": "thread_name", "args": {"name": "phases"}})
    seen_tids: set[int] = set()
    for r in rows:
        kind = r.get("kind")
        if kind == "span" and "t0" in r and "t1" in r:
            args = {k: v for k, v in r.items()
                    if k not in ("kind", "name", "t0", "t1", "seq")}
            ev.append({"name": r["name"], "ph": "X", "cat": "phase",
                       "pid": _PID_PHASES, "tid": 0,
                       "ts": _us(r["t0"]),
                       "dur": max(_us(r["t1"] - r["t0"]), 0.0),
                       "args": args})
        elif kind == "event" and "t" in r:
            name = r["name"]
            if name.startswith("tracker."):
                cost = r.get("cost_s", 0.0)
                ev.append({"name": name, "ph": "X", "cat": "control",
                           "pid": _PID_TRACKER, "tid": 0,
                           "ts": _us(r["t"]),
                           "dur": max(_us(cost), 0.0),
                           "args": {k: v for k, v in r.items()
                                    if k not in ("kind", "name", "t",
                                                 "seq")}})
            else:
                ev.append({"name": name, "ph": "i", "s": "g",
                           "cat": "event", "pid": _PID_PHASES, "tid": 0,
                           "ts": _us(r["t"]),
                           "args": {k: v for k, v in r.items()
                                    if k not in ("kind", "name", "t",
                                                 "seq")}})
        elif kind == "flows":
            track = r.get("track", "fg")
            rnd = r.get("round")
            for j in range(r["n"]):
                s, e = r["t_start"][j], r["t_end"][j]
                if not (_num(s) and _num(e)) or e < s:
                    continue
                src, dst = r["src"][j], r["dst"][j]
                args = {"dst": dst}
                if rnd is not None:
                    args["round"] = rnd
                ev.append({"name": f"{track} {src}->{dst}", "ph": "X",
                           "cat": track, "pid": _PID_PEERS,
                           "tid": int(src), "ts": _us(s),
                           "dur": max(_us(e - s), 0.0), "args": args})
                seen_tids.add(int(src))
    for tid in sorted(seen_tids):
        ev.append({"ph": "M", "pid": _PID_PEERS, "tid": tid,
                   "name": "thread_name",
                   "args": {"name": f"peer {tid}"}})
    return {"traceEvents": ev, "displayTimeUnit": "ms",
            "otherData": {"exporter": "repro_torch.obs",
                          "schema_version": SCHEMA_VERSION}}


def write_perfetto(rows_or_rec, path) -> int:
    """Write the Perfetto trace JSON; returns the traceEvents count."""
    rows = (rows_or_rec if isinstance(rows_or_rec, list)
            else to_jsonl_rows(rows_or_rec))
    trace = to_perfetto(rows)
    with open(path, "w") as fh:
        json.dump(trace, fh)
    return len(trace["traceEvents"])
