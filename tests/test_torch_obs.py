"""The port's telemetry exporters (``repro_torch.obs``) against the JAX
package's (``repro.obs``), on the CPU.

One two-round event session (quorum cut, boundary drain, so every flow
track appears) is recorded by both packages, each recorder on the same
injected clock (a counter, so every span's wall seconds are the same
deterministic numbers in both).  The JSONL rows, the Perfetto trace,
``summarize``/``format_report`` and the ``python -m ... report``,
``validate`` and ``perfetto`` commands must agree: integers and
strings exactly, simulated instants within ``rtol = atol = 1e-9``.
"""
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs                                    # noqa: E402
from repro.core import SwarmConfig as JConfig                    # noqa: E402
from repro.core import SwarmSession as JSession                  # noqa: E402
from repro.net import NetConfig as JNet                          # noqa: E402
from test_torch_session import assert_close_tree                 # noqa: E402

from repro_torch import obs as tobs                              # noqa: E402
from repro_torch.core import SwarmConfig as TConfig              # noqa: E402
from repro_torch.core import SwarmSession as TSession            # noqa: E402
from repro_torch.net import NetConfig as TNet                    # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CFG = dict(n=24, chunks_per_update=8, min_degree=5, s_max=3000, seed=0)
NET_KW = dict(tracker_rtt_s=0.1, latency_lo_s=0.005, latency_hi_s=0.030)
REPORT_TOL = 1e-6           # benchmarks/bench_obs.py's report bound


def _record(obs, session, config, net, **kw):
    ticks = itertools.count(0.0, 0.25)
    with obs.recording(clock=lambda: next(ticks),
                       meta={"test": "torch_obs"}) as rec:
        ses = session(config(**CFG), time_engine="event",
                      net=net(**NET_KW), evolve_overlay=True, **kw)
        ses.run(2, quorum_k=20, bt_budget=2, tail_mode="drain")
    return rec, ses


@pytest.fixture(scope="module")
def recorded():
    jrec, jses = _record(jobs, JSession, JConfig, JNet)
    trec, tses = _record(tobs, TSession, TConfig, TNet, device="cpu")
    return (jrec, jses), (trec, tses)


def _perfetto_without_exporter(trace):
    other = dict(trace["otherData"])
    return dict(trace, otherData=other), other.pop("exporter")


def test_jsonl_rows_equal_to_jax(recorded, tmp_path):
    (jrec, _), (trec, _) = recorded
    jrows, trows = jobs.to_jsonl_rows(jrec), tobs.to_jsonl_rows(trec)
    assert_close_tree(jrows, trows, "rows")
    assert tobs.validate_rows(trows) == []
    tracks = {r["track"] for r in trows if r["kind"] == "flows"}
    assert {"spray", "warmup", "bt", "background"} <= tracks
    path = tmp_path / "round.jsonl"
    assert tobs.write_jsonl(trec, path) == len(trows)
    back = tobs.read_jsonl(path)
    assert_close_tree(trows, back, "read back", tol=0.0)
    assert_close_tree(jobs.read_jsonl(path), back, "read by jax", tol=0.0)
    # every max-min fill is counted once: the foreground transport's
    # segments and the background's fluid solves
    m = {r["name"]: r.get("value") for r in trows if r["kind"] == "metric"}
    assert m["fairshare.maxmin_calls"] == (m["fairshare.solves"]
                                           + m["net.bg_solves"])
    assert m["net.bg_solves"] > 0


def test_perfetto_equal_to_jax(recorded, tmp_path):
    (jrec, _), (trec, _) = recorded
    jt, jexp = _perfetto_without_exporter(
        jobs.to_perfetto(jobs.to_jsonl_rows(jrec)))
    tt, texp = _perfetto_without_exporter(
        tobs.to_perfetto(tobs.to_jsonl_rows(trec)))
    assert (jexp, texp) == ("repro.obs", "repro_torch.obs")
    assert_close_tree(jt, tt, "perfetto")
    out = tmp_path / "trace.json"
    n = tobs.write_perfetto(trec, out)
    trace = json.loads(out.read_text())
    assert n == len(trace["traceEvents"]) == len(tt["traceEvents"])
    assert {0, 1, 2} <= {e["pid"] for e in trace["traceEvents"]}


def test_report_equal_to_jax_and_to_round_metrics(recorded):
    (jrec, _), (trec, tses) = recorded
    js = jobs.summarize(jobs.to_jsonl_rows(jrec))
    ts = tobs.summarize(tobs.to_jsonl_rows(trec))
    assert_close_tree(js, ts, "summary")
    assert jobs.format_report(js) == tobs.format_report(ts)
    wc = tses.wall_clock()
    for r in range(2):
        for k in ("t_warm_s", "t_round_s", "warmup_share_s"):
            assert abs(ts["rounds"][r][k] - wc[k][r]) < REPORT_TOL
    assert abs(ts["totals"]["control_s"]
               - float(wc["control_s"].sum())) < REPORT_TOL


def _cli(module, *argv):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *argv], env=env,
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO)


def test_cli_equal_to_jax(recorded, tmp_path):
    (_, _), (trec, _) = recorded
    path = tmp_path / "round.jsonl"
    tobs.write_jsonl(trec, path)
    for argv in (("validate", str(path)), ("report", str(path)),
                 ("report", str(path), "--json", "--top", "3")):
        j, t = _cli("repro.obs", *argv), _cli("repro_torch.obs", *argv)
        assert t.returncode == j.returncode == 0, t.stderr
        assert t.stdout == j.stdout, argv
    assert "0 violation(s)" in t.stdout or "rounds" in t.stdout
    jout, tout = tmp_path / "j.json", tmp_path / "t.json"
    j = _cli("repro.obs", "perfetto", str(path), str(jout))
    t = _cli("repro_torch.obs", "perfetto", str(path), str(tout))
    assert t.returncode == 0, t.stderr
    assert t.stdout.replace(str(tout), "OUT") == j.stdout.replace(
        str(jout), "OUT")
    assert_close_tree(
        _perfetto_without_exporter(json.loads(jout.read_text()))[0],
        _perfetto_without_exporter(json.loads(tout.read_text()))[0],
        "cli perfetto", tol=0.0)
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"kind": "event", "name": 3}\n')
    t = _cli("repro_torch.obs", "validate", str(bad))
    assert t.returncode == 1 and "violation" in t.stdout


def test_control_plane_counter_exact(recorded):
    (_, _), (trec, tses) = recorded
    total = trec.metrics["tracker.control_s"]["value"]
    per_round = np.array([r.result.metrics.control_s
                          for r in tses.history])
    assert abs(total - per_round.sum()) < REPORT_TOL
    costs = sum(r.get("cost_s", 0.0) for r in trec.rows
                if r.get("name", "").startswith("tracker."))
    assert costs == pytest.approx(per_round.sum())
