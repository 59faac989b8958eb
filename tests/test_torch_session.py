"""The port's multi-round session (``repro_torch.core.session``)
against the JAX package's, on the CPU.

``session.py`` is a copy with the same numpy rng streams (the session's
own churn/overlay stream and every round's simulator stream), so the
membership, the overlays, the schedules and the spray plans are held
exactly, round by round, on both time engines; the event engine's
wall-clock seconds to ``rtol = atol = 1e-9`` (its fair-share solves run
in torch float64 with ``device="cpu"``).  The cross-round adversaries
(``persistent_neighbor_linkage``, ``timing_attribution``) read the
port's traces as the JAX package's read its own.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ChurnAwareSpray as JSpray                 # noqa: E402
from repro.core import ChurnModel as JChurn                      # noqa: E402
from repro.core import SwarmConfig as JConfig                    # noqa: E402
from repro.core import SwarmSession as JSession                  # noqa: E402
from repro.core import attacks as jattacks                       # noqa: E402
from repro.net import NetConfig as JNet                          # noqa: E402

from repro_torch.core import ChurnAwareSpray as TSpray           # noqa: E402
from repro_torch.core import ChurnModel as TChurn                # noqa: E402
from repro_torch.core import SwarmConfig as TConfig              # noqa: E402
from repro_torch.core import SwarmSession as TSession            # noqa: E402
from repro_torch.core import attacks as tattacks                 # noqa: E402
from repro_torch.core import privacy as tprivacy                 # noqa: E402
from repro_torch.core import simulate_round                      # noqa: E402
from repro_torch.net import NetConfig as TNet                    # noqa: E402

RTOL = ATOL = 1e-9
NET_KW = dict(tracker_rtt_s=0.1, latency_lo_s=0.005, latency_hi_s=0.030)
OBS = np.arange(6)


def assert_close_tree(a, b, where="result", tol=RTOL):
    """Two results, recursively: class names, dict keys and array dtypes
    equal; integers, booleans and strings exact; floats within ``tol``
    relative and absolute (RTOL = ATOL by default, 0 for bit equality;
    NaN equal to NaN)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            assert_close_tree(getattr(a, f.name), getattr(b, f.name),
                              f"{where}.{f.name}", tol)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=tol, atol=tol,
                                       err_msg=where)
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_close_tree(a[k], b[k], f"{where}[{k!r}]", tol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_close_tree(x, y, f"{where}[{i}]", tol)
    elif isinstance(a, (float, np.floating)):
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol, err_msg=where)
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


def _sessions(cfg_kw, time_engine="slot", net_kw=None, **ses_kw):
    """The same session through both packages (``churn`` and
    ``spray_policy`` given as their class names' keyword dicts)."""
    churn = ses_kw.pop("churn", None)
    spray = ses_kw.pop("spray_policy", False)
    jkw, tkw = dict(ses_kw), dict(ses_kw)
    if churn is not None:
        jkw["churn"], tkw["churn"] = JChurn(**churn), TChurn(**churn)
    if spray:
        jkw["spray_policy"], tkw["spray_policy"] = JSpray(), TSpray()
    if time_engine == "event":
        jkw["net"], tkw["net"] = JNet(**net_kw), TNet(**net_kw)
        tkw["device"] = "cpu"
    j = JSession(JConfig(**cfg_kw), time_engine=time_engine, **jkw)
    t = TSession(TConfig(**cfg_kw), time_engine=time_engine, **tkw)
    return j, t


def _assert_sessions(j, t):
    """Round by round, then the session-wide surfaces."""
    assert len(j.history) == len(t.history)
    for jr, tr in zip(j.history, t.history):
        where = f"round {jr.round_idx}"
        assert_close_tree(jr.result, tr.result, f"{where}.result")
        for k in ("round_idx", "active_ids", "joined", "left", "rejoined",
                  "dropped_midround", "spray_plan", "late_log", "drain_s",
                  "late_ready", "dead_updates"):
            assert_close_tree(getattr(jr, k), getattr(tr, k),
                              f"{where}.{k}")
        assert_close_tree(jr.global_log(), tr.global_log(),
                          f"{where}.global_log")
    assert j.edge_persistence() == t.edge_persistence()
    assert_close_tree(j.pair_exposure(), t.pair_exposure(), "exposure")
    assert_close_tree(j.wall_clock(), t.wall_clock(), "wall_clock")
    assert_close_tree(j.participation(), t.participation(), "particip")
    assert_close_tree(list(j.offsets), list(t.offsets), "offsets")
    assert_close_tree(j.trace(), t.trace(), "trace")
    assert_close_tree(j.active, t.active, "active")
    assert_close_tree(j.rejoin_at, t.rejoin_at, "rejoin_at")


def test_zero_churn_bit_identical_to_simulate_round():
    cfg = TConfig(n=16, chunks_per_update=12, min_degree=4, s_max=5000,
                  seed=3)
    ses = TSession(cfg)
    for r, rec in enumerate(ses.run(3)):
        ref = simulate_round(cfg.replace(seed=cfg.seed * 1000 + r))
        assert_close_tree(ref, rec.result, f"round {r}", tol=0.0)


@pytest.mark.parametrize("time_engine", ["slot", "event"])
def test_churn_session_equal_to_jax(time_engine):
    cfg = dict(n=24, chunks_per_update=12, min_degree=5, s_max=5000,
               seed=1)
    j, t = _sessions(cfg, time_engine, NET_KW,
                     churn=dict(leave_prob=0.25, join_rate=1.0,
                                rejoin_after=2))
    j.run(4)
    t.run(4)
    assert any(r.left.size for r in t.history), "churn never fired"
    assert any(r.joined.size for r in t.history), "nobody joined"
    _assert_sessions(j, t)
    if time_engine == "event":
        wc = t.wall_clock()
        assert ((wc["warmup_share_s"] > 0)
                & (wc["warmup_share_s"] < 1)).all()


def test_churn_aware_spray_equal_to_jax():
    cfg = dict(n=20, chunks_per_update=16, min_degree=5, s_max=5000,
               seed=3)
    j, t = _sessions(cfg, churn=dict(leave_prob=0.25, rejoin_after=1),
                     spray_policy=True)
    j.run(5)
    t.run(5)
    _assert_sessions(j, t)
    sigma = t.cfg.spray_copies
    for rec in t.history:
        assert len(rec.spray_plan.src) == rec.active_ids.size * sigma
        assert tprivacy.check_eq1(rec.result.log, t.cfg.owner_throttle,
                                  t.cfg.k_gate)
    assert not t.history[-1].spray_plan.fresh.all()   # tunnels reused


def test_geometric_rejoin_equal_to_jax():
    cfg = dict(n=20, chunks_per_update=16, min_degree=5, s_max=5000,
               seed=5)
    j, t = _sessions(cfg, churn=dict(leave_prob=0.3, rejoin_after=2,
                                     rejoin_dist="geometric"))
    delays = []
    for _ in range(10):
        r = t.round_idx
        before = t.rejoin_at.copy()
        j.next_round()
        t.next_round()
        newly = np.flatnonzero((t.rejoin_at >= 0) & (before < 0))
        delays += (t.rejoin_at[newly] - r).tolist()
    _assert_sessions(j, t)
    assert len(set(delays)) > 1 and min(delays) >= 1


def test_async_event_session_carry_and_drain_equal_to_jax():
    """The async settlement and backlog mapping: a quorum-cut event
    session whose tail is carried into the next round's background
    (``tail_mode="carry"``), and one that drains it at the boundary."""
    cfg = dict(n=20, chunks_per_update=8, min_degree=5, s_max=3000,
               seed=0)
    for tail_mode in ("carry", "drain"):
        j, t = _sessions(cfg, "event", NET_KW, evolve_overlay=True)
        kw = dict(quorum_k=20, bt_budget=2, tail_mode=tail_mode)
        j.run(3, **kw)
        t.run(3, **kw)
        _assert_sessions(j, t)
        assert_close_tree(j.wall_trace(), t.wall_trace(), "wall_trace")
        assert any(r.result.cut for r in t.history)
        assert any(r.late_log is not None and len(r.late_log)
                   for r in t.history), tail_mode


def test_persistent_neighbor_linkage_equal_to_jax():
    cfg = dict(n=24, chunks_per_update=16, min_degree=5, s_max=5000,
               seed=0, enable_preround=False, enable_timelag=False)
    j, t = _sessions(cfg, churn=dict(leave_prob=0.1, rejoin_after=1),
                     evolve_overlay=True)
    j.run(6)
    t.run(6)
    exp = t.pair_exposure()
    assert exp.max() >= 3
    want = jattacks.persistent_neighbor_linkage(
        j.trace(), OBS, exposure=j.pair_exposure(), min_rounds=3)
    got = tattacks.persistent_neighbor_linkage(
        t.trace(), OBS, exposure=exp, min_rounds=3)
    assert_close_tree(want, got, "linkage")
    assert got.n_decisions > 0


@pytest.mark.parametrize("defences", ["none", "full"])
def test_timing_attribution_on_event_traces_equal_to_jax(defences):
    off = dict(enable_preround=False, enable_timelag=False,
               enable_gating=False, enable_nonowner_first=False)
    cfg = dict(n=24, chunks_per_update=16, min_degree=5, s_max=5000,
               seed=2, **(off if defences == "none" else {}))
    j, t = _sessions(cfg, "event", NET_KW)
    j.run(2)
    t.run(2)
    for jr, tr in zip(j.history, t.history):
        for pooled in (False, True):
            want = jattacks.timing_attribution(jr.result.log, OBS, 16,
                                               pooled=pooled)
            got = tattacks.timing_attribution(tr.result.log, OBS, 16,
                                              pooled=pooled)
            assert_close_tree(want, got, f"timing pooled={pooled}")
            assert got.n_decisions > 0


def test_event_session_needs_a_device_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    cfg = TConfig(n=12, chunks_per_update=8, min_degree=4, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSession(cfg, time_engine="event")
    TSession(cfg).run(1)        # the slot engine needs no device
