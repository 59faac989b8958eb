"""The port's FLTorrent core (``repro_torch.core``) against the JAX
package's (``repro.core``), on the CPU.

The host-side modules are copies with the same numpy rng streams, so
every comparison here is exact: the golden schedule digests and attack
numbers of ``tests/golden_schedules.json`` (against the file and
against the JAX package run in this process), whole round results
(metrics, A_v, the active set, the trace) at a second size and for the
n = 16, K = 540 ``DATACENTER`` swarm that ``chip_smoke.py`` aggregates
on the card, the Eq. 1 to 5 bounds, the max-flow stage bound, a
Byzantine round, the audit, the policy registry and its visibility
gate, the recorder and the event engine's refusal to run on the CPU
unless asked.  The jit slot engine has its own file,
tests/test_torch_jit_engine.py.
"""
import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs                                  # noqa: E402
from repro.core import SwarmConfig as JConfig                  # noqa: E402
from repro.core import attacks as jattacks                     # noqa: E402
from repro.core import audit as jaudit                         # noqa: E402
from repro.core import byzantine as jbyz                       # noqa: E402
from repro.core import capacities as jcap                      # noqa: E402
from repro.core import privacy as jprivacy                     # noqa: E402
from repro.core.simulator import RoundSimulator as JSim        # noqa: E402
from test_scheduler_equivalence import _replay_legality        # noqa: E402

from repro_torch import obs as tobs                            # noqa: E402
from repro_torch.core import SchedulerPolicy, VisibilityError  # noqa: E402
from repro_torch.core import SwarmConfig as TConfig            # noqa: E402
from repro_torch.core import attacks as tattacks               # noqa: E402
from repro_torch.core import audit as taudit                   # noqa: E402
from repro_torch.core import byzantine as tbyz                 # noqa: E402
from repro_torch.core import capacities as tcap                # noqa: E402
from repro_torch.core import get_policy, policy_names          # noqa: E402
from repro_torch.core import privacy as tprivacy               # noqa: E402
from repro_torch.core import register_policy                   # noqa: E402
from repro_torch.core import simulator as tsim_mod             # noqa: E402
from repro_torch.core.simulator import RoundSimulator as TSim  # noqa: E402

GOLDEN = json.loads((Path(__file__).parent
                     / "golden_schedules.json").read_text())
MODES = ["random_fifo", "random_fastest_first", "greedy_fastest_first",
         "distributed", "flooding"]
LOG_KEYS = ("slot", "sender", "receiver", "chunk", "owner",
            "b_size", "o_size", "phase")
ABLATIONS = {"full": {},
             "none": dict(enable_preround=False, enable_timelag=False,
                          enable_gating=False, enable_nonowner_first=False)}


def _digest(log) -> str:
    """tests/capture_golden.py's digest of a transfer log."""
    h = hashlib.sha256()
    for key in LOG_KEYS:
        arr = np.ascontiguousarray(np.asarray(log[key], dtype=np.int64))
        h.update(key.encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _assert_same(a, b, where="result"):
    """Exact, recursive equality of two packages' results: dataclasses
    field by field, arrays in value and dtype, dicts key by key."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{where}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


def _both(sim_kw=None, run_kw=None, **cfg_kw):
    """One round of the same config through both packages."""
    sim_kw, run_kw = sim_kw or {}, run_kw or {}
    jkw = {k: (getattr(jcap, v) if k == "link_model" else v)
           for k, v in sim_kw.items()}
    tkw = {k: (getattr(tcap, v) if k == "link_model" else v)
           for k, v in sim_kw.items()}
    j = JSim(JConfig(**cfg_kw), **jkw).run(**run_kw)
    t = TSim(TConfig(**cfg_kw), **tkw).run(**run_kw)
    return j, t


# ---------------------------------------------------------------------------
# the golden schedules and attack numbers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 9])
@pytest.mark.parametrize("impl", ["batched", "loop"])
@pytest.mark.parametrize("mode", MODES)
def test_golden_schedule_digest(mode, impl, seed):
    kw = dict(n=16, chunks_per_update=24, s_max=5000, seed=seed,
              scheduler=mode, scheduler_impl=impl)
    j, t = _both(**kw)
    want = GOLDEN["schedules"][f"{mode}/{impl}/{seed}"]
    assert _digest(t.log) == want
    assert _digest(j.log) == want
    _replay_legality(TConfig(**kw), t,
                     check_tau=mode in ("random_fifo", "random_fastest_first",
                                        "greedy_fastest_first"))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(ABLATIONS))
def test_golden_attack_numbers_exact(name, seed):
    t = TSim(TConfig(n=24, chunks_per_update=24, s_max=5000, seed=seed,
                     scheduler_impl="loop", **ABLATIONS[name])).run()
    reps = tattacks.run_all_attacks(t.log, np.arange(6), 24)
    pooled = tattacks.run_all_attacks(t.log, np.arange(12), 24, pooled=True)
    got = {a: {"max": reps[a].max_asr, "mean": reps[a].mean_asr,
               "n": reps[a].n_decisions, "pooled_max": pooled[a].max_asr,
               "pooled_any": pooled[a].any_correct_rate} for a in reps}
    assert got == GOLDEN["attacks"][f"{name}/{seed}"]


# ---------------------------------------------------------------------------
# whole rounds equal to JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["greedy_fastest_first", "distributed",
                                  "flooding"])
def test_round_equal_to_jax_at_a_second_size(mode):
    j, t = _both(n=40, chunks_per_update=32, s_max=5000, seed=5,
                 scheduler=mode, min_degree=6)
    _assert_same(j, t)
    assert not t.metrics.failed_open and t.reconstructable.all()


@pytest.mark.parametrize("s_max,pairs", [(30, 46), (None, 256)])
def test_datacenter_swarm_equal_to_jax(s_max, pairs):
    """The swarm whose per-peer FedAvg chip_smoke.py runs on the card:
    16 peers of 540 4 MiB pieces, DATACENTER links, exact BitTorrent."""
    kw = dict(n=16, chunks_per_update=540, chunk_bytes=4 << 20, seed=0,
              min_degree=10)
    if s_max is not None:
        kw["s_max"] = s_max
    j, t = _both(sim_kw=dict(link_model="DATACENTER", bt_mode="exact"), **kw)
    _assert_same(j, t)
    assert int(t.reconstructable.sum()) == pairs
    assert np.diag(t.reconstructable).all()
    if s_max is not None:
        assert len(np.unique(t.reconstructable, axis=0)) > 1


def test_maxflow_stage_bound_equal():
    j, t = _both(run_kw=dict(collect_maxflow=True), n=16,
                 chunks_per_update=12, s_max=5000, seed=2)
    assert t.maxflow_ub is not None and len(t.maxflow_ub) == t.metrics.t_warm
    _assert_same(j.maxflow_ub, t.maxflow_ub)


def test_byzantine_round_equal():
    beh = {1: "lie", 4: "withhold", 7: "slow"}
    kw = dict(n=20, chunks_per_update=16, s_max=400, seed=3)
    j = JSim(JConfig(**kw), byzantine=jbyz.ByzantineModel(
        behaviours=beh, timeout_slots=4)).run()
    t = TSim(TConfig(**kw), byzantine=tbyz.ByzantineModel(
        behaviours=beh, timeout_slots=4)).run()
    _assert_same(j, t)


def test_dropouts_equal():
    j, t = _both(sim_kw=dict(dropouts={3: [2, 5], 9: [11]}), n=20,
                 chunks_per_update=16, s_max=400, seed=4)
    _assert_same(j, t)
    assert not t.active[[2, 5, 11]].any()


# ---------------------------------------------------------------------------
# privacy bounds (Eq. 1 to 5), attacks, audit
# ---------------------------------------------------------------------------

def test_eq1_and_posteriors_equal():
    kw = dict(n=24, chunks_per_update=24, s_max=5000, seed=0)
    j, t = _both(**kw)
    cfg = TConfig(**kw)
    assert tprivacy.check_eq1(t.log, cfg.owner_throttle, cfg.k_gate)
    assert (tprivacy.check_eq1(t.log, cfg.owner_throttle, cfg.k_gate)
            == jprivacy.check_eq1(j.log, cfg.owner_throttle, cfg.k_gate))
    for warm in (True, False):
        _assert_same(jprivacy.empirical_posteriors(j.log, warm),
                     tprivacy.empirical_posteriors(t.log, warm))
    _assert_same(jprivacy.spray_mean_adj(3, j.adj, 5),
                 tprivacy.spray_mean_adj(3, t.adj, 5))


@pytest.mark.parametrize("kappa,k_gate", [(1, 4), (2, 3), (3, 0), (5, 5)])
def test_privacy_bounds_equal(kappa, k_gate):
    same = [
        ("per_transfer_cap", (kappa, k_gate)),
        ("unlinkability_level", (kappa, k_gate)),
        ("spray_mean", (3, 100)),
        ("chernoff_lower_tail", (7.5, 0.3)),
        ("lead_probability", (kappa + 1,)),
        ("lag_mass_mean", (10.0, kappa + 2, 0.8)),
        ("high_prob_posterior_bound", (kappa, 3.0, 10.0, 4, 0.8, 0.25)),
        ("alliance_filter_bound", (kappa, k_gate, 6.0, 0.2, 0.5)),
        ("collusion_high_prob_bound", (kappa, k_gate, 3, 10.0, 4, 0.8,
                                       0.2, 0.5, 0.25)),
        ("repeated_observation_bound", (3, kappa, k_gate, 6.0, 0.2, 0.5)),
    ]
    for name, args in same:
        assert getattr(tprivacy, name)(*args) == \
            getattr(jprivacy, name)(*args), name


def test_observation_attacks_equal_on_a_round():
    j, t = _both(n=30, chunks_per_update=16, s_max=5000, seed=6,
                 enable_preround=False)
    for fn in ("sequential_greedy", "amount_greedy", "clustering",
               "sequential_greedy_reference", "amount_greedy_reference",
               "clustering_reference"):
        _assert_same(getattr(jattacks, fn)(j.log, np.arange(8), 16),
                     getattr(tattacks, fn)(t.log, np.arange(8), 16))
    _assert_same(jattacks.random_guess_baseline(6.5),
                 tattacks.random_guess_baseline(6.5))


def test_audit_equal():
    kw = dict(n=20, chunks_per_update=12, s_max=5000, seed=8)
    j, t = _both(**kw)
    cfg = TConfig(**kw)
    out = {}
    for pkg, mod, res in (("jax", jaudit, j), ("torch", taudit, t)):
        com = mod.TrackerCommitment.commit(7, cfg.seed)
        rl = mod.RoundLog(round_id=7, seed=cfg.seed, n=cfg.n,
                          min_degree=cfg.min_degree,
                          extra_edge_frac=cfg.extra_edge_frac,
                          adjacency_digest=mod.adjacency_digest(res.adj),
                          directives=mod.directives_from_trace(res.log))
        forged = dataclasses.replace(rl, seed=cfg.seed + 1)
        # a repeated delivery and a directive between non-neighbours
        u, v = map(int, np.argwhere(~res.adj & ~np.eye(cfg.n, dtype=bool))[0])
        bad = list(rl.directives[:3]) + [rl.directives[0], (0, u, v, 0)]
        out[pkg] = (mod.verify_round(com, rl, res.up, res.down),
                    mod.verify_round(com, forged, res.up, res.down),
                    mod.verify_directives(res.adj, bad, res.up, res.down),
                    rl.digest())
    ok, forged, dirs, digest = out["torch"]
    assert ok.ok and not forged.ok and len(dirs) == 2
    for a, b in zip(out["jax"], out["torch"]):
        _assert_same(a, b)
    assert (jaudit.TrackerCommitment.commit(7, 8).commitment
            == taudit.TrackerCommitment.commit(7, 8).commitment)


# ---------------------------------------------------------------------------
# the policy API, the recorder, what is not ported
# ---------------------------------------------------------------------------

@register_policy
class MirrorPolicy(SchedulerPolicy):
    """examples/custom_policy.py's EagerMirror, in the port's registry."""

    name = "test_torch_core_mirror"
    visibility = "neighborhood"

    def schedule(self, view):
        cand, union = view.availability_union()
        snd, rcv, chk = [], [], []
        for v in np.flatnonzero(view.receivers_open()):
            ids = np.flatnonzero(union[v])[:int(view.down[v])]
            if ids.size == 0:
                continue
            tgt = view.rng.choice(np.flatnonzero(view.adj[v]), size=ids.size)
            ok = view.resolve_requests(tgt, cand[ids])
            snd.append(tgt[ok])
            rcv.append(np.full(int(ok.sum()), v, np.int64))
            chk.append(cand[ids[ok]])
        if not snd:
            return view.empty()
        snd, rcv, chk = map(np.concatenate, (snd, rcv, chk))
        o = np.argsort(snd, kind="stable")
        rank = np.arange(o.size) - np.searchsorted(snd[o], snd[o])
        keep = np.zeros(o.size, bool)
        keep[o] = rank < view.up[snd[o]]
        return snd[keep], rcv[keep], chk[keep]


class OverReach(SchedulerPolicy):
    name = "test_torch_core_overreach"
    visibility = "neighborhood"

    def schedule(self, view):
        view.supply()                  # a "full" accessor
        return view.empty()


def test_custom_policy_by_name_and_instance():
    assert "test_torch_core_mirror" in policy_names()
    assert isinstance(get_policy("test_torch_core_mirror"), MirrorPolicy)
    kw = dict(n=24, chunks_per_update=16, min_degree=5, s_max=5000, seed=0)
    by_name = TSim(TConfig(scheduler="test_torch_core_mirror", **kw)).run()
    by_inst = TSim(TConfig(scheduler=MirrorPolicy(), **kw)).run()
    assert by_name.metrics.t_warm > 0 and not by_name.metrics.failed_open
    assert _digest(by_name.log) == _digest(by_inst.log)
    _replay_legality(TConfig(**kw), by_name, check_tau=False)


def test_visibility_error_on_an_over_reaching_policy():
    sim = TSim(TConfig(n=12, chunks_per_update=8, min_degree=4, s_max=50,
                       seed=1, scheduler=OverReach()))
    with pytest.raises(VisibilityError):
        sim.run()


def test_recording_is_inert_and_matches_jax():
    kw = dict(n=16, chunks_per_update=24, s_max=5000, seed=1)
    plain = TSim(TConfig(**kw)).run()
    assert not tobs.get().enabled
    with tobs.recording() as trec:
        t = TSim(TConfig(**kw)).run()
    with jobs.recording() as jrec:
        JSim(JConfig(**kw)).run()
    assert not tobs.get().enabled
    assert _digest(t.log) == _digest(plain.log)
    spans = [r["name"] for r in trec.rows if r["kind"] == "span"]
    assert spans == ["round.spray", "round.warmup", "round.bt",
                     "round.emit", "round.total"]
    assert len(jrec.rows) == len(trec.rows)
    for a, b in zip(jrec.rows, trec.rows):
        _assert_same(a, b, f"row {a.get('name')}")
    _assert_same(jrec.metrics, trec.metrics)


def test_measured_clock_installs_and_restores():
    ticks = iter(range(100))
    with tsim_mod.measured_clock(lambda: float(next(ticks))) as clk:
        assert tsim_mod._clock is clk
        res = TSim(TConfig(n=12, chunks_per_update=8, min_degree=4,
                           s_max=500, seed=2)).run()
    assert tsim_mod._clock is tsim_mod._zero_clock
    assert sum(res.timings.values()) > 0
    with pytest.raises(RuntimeError):
        with tsim_mod.measured_clock():
            raise RuntimeError("boom")
    assert tsim_mod._clock is tsim_mod._zero_clock


def test_round_clock_starts_before_the_event_engine(monkeypatch):
    """The round clock's first reading precedes the ``EventEngine``'s
    construction in both packages (repro/core/simulator.py:433-441):
    with an injected clock that the engine's constructor advances by
    1000, ``timings["spray_s"]`` and the ``round.spray`` and
    ``round.total`` spans' ``wall_s`` are equal in both and include the
    construction."""
    import repro.core.simulator as jsim_mod
    import repro.net as jnet

    import repro_torch.net as tnet

    def run(sim_mod, engine_cls, obs_mod, make):
        now = [0.0]

        def clock():
            now[0] += 1.0
            return now[0]

        init = engine_cls.__init__

        def slow_init(self, *a, **kw):
            init(self, *a, **kw)
            now[0] += 1000.0

        monkeypatch.setattr(engine_cls, "__init__", slow_init)
        sim_mod.set_clock(clock)
        try:
            with obs_mod.recording() as rec:
                res = make()
        finally:
            sim_mod.set_clock(None)
            monkeypatch.setattr(engine_cls, "__init__", init)
        spans = {r["name"]: r["wall_s"] for r in rec.rows
                 if r.get("name") in ("round.spray", "round.total")}
        return res.timings, spans

    kw = dict(n=12, chunks_per_update=8, min_degree=4, s_max=500, seed=4)
    jt, js = run(jsim_mod, jnet.EventEngine, jobs,
                 lambda: jsim_mod.RoundSimulator(
                     JConfig(**kw), time_engine="event").run())
    tt, ts = run(tsim_mod, tnet.EventEngine, tobs,
                 lambda: TSim(TConfig(**kw), time_engine="event",
                              device="cpu").run())
    assert tt == jt and ts == js
    assert tt["spray_s"] >= 1000.0
    assert ts["round.spray"] == tt["spray_s"] >= 1000.0
    assert ts["round.total"] >= 1000.0


def test_event_engine_refuses_the_cpu_without_a_device(monkeypatch):
    """No GPU and no ``device``: the event engine raises from
    ``resolve_device`` before any solve, and never falls back to the
    CPU or to the numpy plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from repro_torch.core import simulate_round
    from repro_torch.kernels import fairshare as kernels
    from repro_torch.net import fairshare

    def never(*a, **k):
        raise AssertionError("a fair-share solve ran")

    for module, name in ((kernels, "_maxmin_fill"),
                         (kernels, "_transport_device"),
                         (fairshare, "maxmin_rates_plain"),
                         (fairshare, "transport_plain")):
        monkeypatch.setattr(module, name, never)
    cfg = TConfig(n=12, chunks_per_update=8, min_degree=4, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_round(cfg, time_engine="event")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSim(cfg, time_engine="event", device=None)
    with pytest.raises(ValueError, match="unknown time_engine"):
        TSim(cfg, time_engine="wall")
    assert simulate_round(cfg).metrics.t_round > 0   # slot: no device
