"""The port's deadline-free FedBuff runner (``repro_torch.fl.asyncfl``)
against the JAX package's, on the CPU.

The dissemination side is the port's copy of the session with the same
rng streams and its fair-share solves in torch float64 on the CPU, so
what it decides is held exactly: updates merged, of which stale, the
staleness histogram, drops, the buffer left at the end; the wall clock
to 1e-9.  Accuracies are held to one test sample a round, from JAX's
initial weights (``params0``), in the rounds where a one-ulp change of
those weights does not move the port's own accuracy by more.  The port's two runners are held to each
other float-exactly (``AsyncConfig()`` is the synchronous runner)."""
import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import SwarmConfig as JConfig
from repro.core import SwarmSession as JSession
from repro.data.synthetic import make_synthetic
from repro.fl import asyncfl as jasync
from repro.fl import client as jclient
from repro.fl import models_small as jmodels
from repro.fl import runner as jrunner
from repro.net import NetConfig as JNet

from repro_torch import obs as tobs
from repro_torch.core import SwarmConfig as TConfig
from repro_torch.core import SwarmSession as TSession
from repro_torch.fl import asyncfl as tasync
from repro_torch.fl import client as tclient
from repro_torch.fl import runner as trunner
from repro_torch.net import NetConfig as TNet

TOL = 1e-9
NET_KW = dict(tracker_rtt_s=0.1, latency_lo_s=0.005, latency_hi_s=0.030)
TINY = dict(dataset="synth-mnist", n_clients=6, rounds=3, n_train=600,
            n_test=200, min_degree=3, seed=3,
            local=dict(epochs=1, batch_size=32, lr=0.05))
SCFG = dict(n=10, chunks_per_update=6, min_degree=3, s_max=3000, seed=7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several processes at once; torch's default of a
    thread a core in each would oversubscribe the CPU many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(**kw):
    local = kw.pop("local", {})
    return (jrunner.FLConfig(local=jclient.LocalSpec(**local), **kw),
            trunner.FLConfig(local=tclient.LocalSpec(**local), **kw))


def _acfgs(**kw):
    """The same AsyncConfig for both packages (``net`` given as True for
    the test NetConfig)."""
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("net", None):
        jkw["net"], tkw["net"] = JNet(**NET_KW), TNet(**NET_KW)
    return jasync.AsyncConfig(**jkw), tasync.AsyncConfig(**tkw)


def _params0(jcfg):
    train, _ = make_synthetic(jcfg.dataset, jcfg.n_train, jcfg.n_test,
                              seed=jcfg.seed)
    return jax.tree_util.tree_map(np.asarray, jmodels.MODELS[jcfg.model][0](
        jax.random.PRNGKey(jcfg.seed), train.x.shape[1:],
        train.num_classes))


def ulp_bumped(params0):
    """``params0`` with every weight one ulp larger (the biases, zero,
    kept)."""
    return jax.tree_util.tree_map(
        lambda a: np.where(a != 0, np.nextafter(a, np.float32(np.inf)), a),
        params0)


def rounds_held(run, params0, n_test) -> int:
    """The rounds before the first in which a one-ulp change of the
    initial weights moves the port's own accuracy by more than one test
    sample (tests/test_torch_fl.py says why)."""
    a = run(params0).accuracy
    b = run(ulp_bumped(params0)).accuracy
    held = next((r for r, (x, y) in enumerate(zip(a, b))
                 if abs(x - y) > 1.0 / n_test + 1e-12), len(a))
    assert held >= 1, "a one-ulp change moves round 1's accuracy"
    return held


# -- validation -------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(overlap=True), "max_staleness >= 1"),
    (dict(buffer_k=2, max_staleness=1, overlap=True), "time_engine='event'"),
    (dict(max_staleness=2), "buffer_k >= 1"),
    (dict(round_slots=4), "async tail"),
    (dict(buffer_k=2, max_staleness=1, round_slots=0), "round_slots must"),
    (dict(buffer_k=2, max_staleness=1, server_lr=0.0), "server_lr"),
    (dict(server_lr=0.5), "parity mode")])
def test_async_config_validation_matches_jax(kw, match):
    with pytest.raises(ValueError, match=match) as t:
        tasync.AsyncConfig(**kw)
    with pytest.raises(ValueError) as j:
        jasync.AsyncConfig(**kw)
    assert str(t.value) == str(j.value)


# -- sync parity: AsyncConfig() IS the synchronous runner -------------------

@pytest.mark.parametrize("extra", [
    {}, dict(churn_rate=0.3, rejoin_after=1, rounds=4),
    dict(model="cnn", rounds=2)])
def test_sync_parity_float_exact_in_the_port(extra):
    _, tcfg = _cfgs(**dict(TINY, **extra))
    ref = trunner.run_experiment("fltorrent", tcfg, device="cpu")
    par = tasync.run_async_experiment(tcfg, tasync.AsyncConfig(),
                                      device="cpu")
    assert par.accuracy == ref.accuracy          # float-exact, no atol
    assert par.agreement == ref.agreement
    assert par.reconstruct_frac == ref.reconstruct_frac
    assert par.participation == ref.participation
    assert par.dropped == 0 and par.staleness_hist == {}
    assert par.stale_merged == [0] * tcfg.rounds


# -- async modes against JAX ------------------------------------------------

ASYNC_MODES = {
    "carry": dict(buffer_k=2, max_staleness=2, overlap=True, round_slots=2,
                  time_engine="event", net=True, evolve_overlay=True),
    "drain-event": dict(buffer_k=2, max_staleness=2, round_slots=2,
                        time_engine="event", net=True, evolve_overlay=True,
                        server_lr=0.5),
    "drain-slot": dict(buffer_k=3, max_staleness=1, round_slots=1,
                       evolve_overlay=True, staleness_alpha=1.0),
    "sync-event": dict(time_engine="event", net=True),
}
EXACT = ("merged", "stale_merged", "staleness_hist", "dropped",
         "buffer_end", "agreement", "reconstruct_frac", "participation")


@pytest.mark.parametrize("mode", sorted(ASYNC_MODES))
def test_async_runner_matches_jax(mode):
    jcfg, tcfg = _cfgs(**TINY)
    jac, tac = _acfgs(**ASYNC_MODES[mode])
    with jobs.recording() as jrec:
        want = jasync.run_async_experiment(jcfg, jac)
    p0 = _params0(jcfg)
    with tobs.recording() as trec:
        got = tasync.run_async_experiment(tcfg, tac, device="cpu",
                                          params0=p0)
    for f in EXACT:
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_allclose(got.wall_s, want.wall_s, rtol=TOL,
                               atol=TOL)
    held = rounds_held(lambda p: tasync.run_async_experiment(
        tcfg, tac, device="cpu", params0=p), p0, jcfg.n_test)
    np.testing.assert_allclose(got.accuracy[:held], want.accuracy[:held],
                               rtol=0, atol=1.0 / jcfg.n_test + 1e-12)
    assert got.session.device == torch.device("cpu") or \
        got.session.device is None
    if mode != "sync-event":
        assert sum(got.stale_merged) > 0, "the mode must merge late"
    # The recording mirrors the result (tests/test_obs.py) and JAX's;
    # the synchronous merge records no async event.
    merges = [r for r in trec.rows if r.get("name") == "async.merge"]
    assert [e["merged"] for e in merges] == (
        [] if mode == "sync-event" else [m for m in got.merged if m > 0])
    jmerges = [r for r in jrec.rows if r.get("name") == "async.merge"]
    assert len(merges) == len(jmerges)
    for a, b in zip(jmerges, merges):
        assert {k: v for k, v in a.items() if k != "t"} == \
            {k: v for k, v in b.items() if k != "t"}
        assert b["t"] == pytest.approx(a["t"], rel=TOL, abs=TOL)
    hist = trec.metrics.get("async.staleness", {"values": []})["values"]
    assert sorted(int(v) for v in hist) == sorted(
        s for s, c in got.staleness_hist.items() for _ in range(c))
    for name in ("async.dropped", "async.merges"):
        assert trec.metrics.get(name, {"value": 0.0})["value"] == \
            jrec.metrics.get(name, {"value": 0.0})["value"], name
    assert trec.metrics.get("async.dropped",
                            {"value": 0.0})["value"] == got.dropped


# -- adversary_view ---------------------------------------------------------

def _assert_views_equal(jv, tv):
    assert len(jv) == len(tv) and jv.K == tv.K
    assert tuple(jv.keys()) == tuple(tv.keys())
    for k in jv.keys():
        a, b = getattr(jv, k), getattr(tv, k)
        assert a.dtype == b.dtype, k
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


def test_adversary_view_matches_jax_on_a_carry_session():
    js = JSession(JConfig(**SCFG), time_engine="event", net=JNet(**NET_KW),
                  evolve_overlay=True)
    ts = TSession(TConfig(**SCFG), time_engine="event", net=TNet(**NET_KW),
                  evolve_overlay=True, device="cpu")
    js.run(4, quorum_k=SCFG["n"], tail_mode="carry", bt_budget=2)
    ts.run(4, quorum_k=SCFG["n"], tail_mode="carry", bt_budget=2)
    jv, tv = jasync.adversary_view(js), tasync.adversary_view(ts)
    _assert_views_equal(jv, tv)
    # The band shift (tests/test_asyncfl.py): late rows sit past every
    # fresh descriptor and decode back to their generation.
    K, band = SCFG["chunks_per_update"], ts.n_peers + 1
    late = tv.phase == 1
    assert int(tv.chunk[~late].max()) < band * K
    lv = tv.chunk[late]
    assert lv.size and (lv >= band * K).all()
    np.testing.assert_array_equal(lv // (band * K) - 1,
                                  tv.generation[late].astype(np.int64))


def test_adversary_view_of_an_async_run_matches_jax():
    jcfg, tcfg = _cfgs(**TINY)
    jac, tac = _acfgs(**ASYNC_MODES["carry"])
    want = jasync.run_async_experiment(jcfg, jac)
    got = tasync.run_async_experiment(tcfg, tac, device="cpu")
    _assert_views_equal(jasync.adversary_view(want.session),
                        tasync.adversary_view(got.session))
    # No late rows: the view is the plain session trace.
    ses = TSession(TConfig(**SCFG), device="cpu")
    ses.run(2)
    _assert_views_equal(ses.trace(), tasync.adversary_view(ses))


def test_async_runner_needs_a_device_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    _, tcfg = _cfgs(**dict(TINY, rounds=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tasync.run_async_experiment(tcfg, tasync.AsyncConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tasync.run_async_experiment(tcfg, tasync.AsyncConfig(**dict(
            ASYNC_MODES["carry"], net=TNet(**NET_KW))))
