"""The port's event engine (``repro_torch.net``) against the JAX
package's (``repro.net``), on the CPU.

Every comparison feeds the same seeded numpy inputs to both packages;
the port runs its fair-share solves in torch float64 with
``device="cpu"``.  Integer fields (``chunk_flow``, ``n_solves``, the
schedules, the tracker's cycle ledger) are held exactly; rates and
instants to ``rtol = atol = 1e-9``.  Against its own plain numpy
versions (``maxmin_rates_plain``, ``transport_plain``) the CPU solver is
held bit for bit: the operation order is the same and every op is
correctly rounded.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import SwarmConfig as JConfig                  # noqa: E402
from repro.core import capacities as jcap                      # noqa: E402
from repro.core import maxflow as jmaxflow                     # noqa: E402
from repro.core.simulator import RoundSimulator as JSim        # noqa: E402
from repro.net import fairshare as jfs                         # noqa: E402
from repro.net import NetConfig as JNet                        # noqa: E402

from repro_torch.core import SwarmConfig as TConfig            # noqa: E402
from repro_torch.core import capacities as tcap                # noqa: E402
from repro_torch.core import maxflow as tmaxflow               # noqa: E402
from repro_torch.core import privacy as tprivacy               # noqa: E402
from repro_torch.core.simulator import RoundSimulator as TSim  # noqa: E402
from repro_torch.net import NetConfig as TNet                  # noqa: E402
from repro_torch.net import fairshare as tfs                   # noqa: E402

RTOL = ATOL = 1e-9
TIME_KEYS = ("t_start", "t_end")
LOG_INT_KEYS = ("slot", "sender", "receiver", "chunk", "owner", "b_size",
                "o_size", "phase")

# tests/test_net.py's small cases: (src, dst, up, down)
MAXMIN_SMALL = [
    ([0, 0, 0], [1, 2, 3], [9.0] * 4, [100.0] * 4),
    ([0, 0], [1, 2], [10.0, 100.0, 100.0], [100.0, 2.0, 100.0]),
]
# (src, dst, counts, chunk_bytes, up, down)
TRANSPORT_SMALL = [
    ([0, 1], [2, 2], [5, 3], 10.0, [10.0, 10.0, 10.0], [10.0, 10.0, 8.0]),
    (list(range(4)), [4] * 4, [6] * 4, 2.0, [100.0] * 5, [12.0] * 5),
]


def _links(seed, n, f, zero_cap=False):
    """Seeded heterogeneous links over six decades, flows without
    self-loops; ``zero_cap`` zeroes one uplink and one downlink."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, f)
    dst = (src + 1 + rng.integers(0, n - 1, f)) % n
    up = rng.uniform(1.0, 50.0, n) * 10.0 ** rng.integers(0, 6, n)
    down = rng.uniform(1.0, 50.0, n) * 10.0 ** rng.integers(0, 6, n)
    if zero_cap:
        up[src[0]] = 0.0
        down[dst[-1]] = 0.0
    counts = rng.integers(1, 9, f)
    return src, dst, counts, up, down


# (seed, n, f, zero_cap, max_passes, quantum_frac)
SEEDED = [
    (0, 12, 60, False, 16, 1 / 64),
    (1, 30, 200, False, 1, 1 / 64),        # test_net's truncated tail
    (2, 40, 300, True, 16, 1 / 64),        # zero-capacity links
    (3, 20, 120, False, 2, 0.0),           # tail at 2 passes; exact events
    (4, 60, 400, True, 2, 1 / 32),
    (5, 2, 10, False, 16, 0.0),
    (6, 25, 150, False, 16, 1 / 32),
]


def _assert_timings(a, b, exact=False):
    """Two ``FlowTimings``: ``chunk_flow`` and ``n_solves`` exact; the
    instants within RTOL/ATOL (or bit for bit)."""
    np.testing.assert_array_equal(a.chunk_flow, b.chunk_flow)
    assert a.n_solves == b.n_solves
    assert np.array_equal(np.isfinite(a.finish), np.isfinite(b.finish))
    for x, y in ((a.finish, b.finish), (a.chunk_end, b.chunk_end),
                 (np.float64(a.makespan), np.float64(b.makespan))):
        if exact:
            np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# fair-share solves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(len(MAXMIN_SMALL)))
def test_maxmin_small_cases(case):
    src, dst, up, down = (np.asarray(x) for x in MAXMIN_SMALL[case])
    want = jfs.maxmin_rates(src, dst, up, down)
    got = tfs.maxmin_rates(src, dst, up, down, device="cpu")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        got, tfs.maxmin_rates_plain(src, dst, up, down))


@pytest.mark.parametrize("seed,n,f,zero_cap,max_passes,_q", SEEDED)
def test_maxmin_seeded_heterogeneous(seed, n, f, zero_cap, max_passes, _q):
    src, dst, _, up, down = _links(seed, n, f, zero_cap)
    want = jfs.maxmin_rates(src, dst, up, down, max_passes)
    got = tfs.maxmin_rates(src, dst, up, down, max_passes, device="cpu")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        got, tfs.maxmin_rates_plain(src, dst, up, down, max_passes))
    if zero_cap:
        assert (got[(up[src] == 0) | (down[dst] == 0)] == 0).all()
    # never oversubscribes a link (test_net's feasibility check)
    assert (np.bincount(src, got, n) <= up * (1 + 1e-6)).all()
    assert (np.bincount(dst, got, n) <= down * (1 + 1e-6)).all()


@pytest.mark.parametrize("case", range(len(TRANSPORT_SMALL)))
def test_transport_small_cases(case):
    src, dst, counts, cb, up, down = TRANSPORT_SMALL[case]
    args = (np.asarray(src), np.asarray(dst), np.asarray(counts), cb,
            np.asarray(up), np.asarray(down))
    got = tfs.transport(*args, device="cpu")
    _assert_timings(got, jfs.transport(*args))
    _assert_timings(got, tfs.transport_plain(*args), exact=True)
    assert (np.bincount(got.chunk_flow) == np.asarray(counts)).all()


@pytest.mark.parametrize("seed,n,f,zero_cap,_mp,quantum_frac", SEEDED)
def test_transport_seeded_heterogeneous(seed, n, f, zero_cap, _mp,
                                        quantum_frac):
    src, dst, counts, up, down = _links(seed, n, f, zero_cap)
    args = (src, dst, counts, 1000.0, up, down)
    got = tfs.transport(*args, quantum_frac=quantum_frac, device="cpu")
    _assert_timings(got, jfs.transport(*args, quantum_frac=quantum_frac))
    _assert_timings(got, tfs.transport_plain(
        *args, quantum_frac=quantum_frac), exact=True)
    dead = (up[src] == 0) | (down[dst] == 0)
    assert np.isinf(got.finish[dead]).all()
    assert not np.isin(got.chunk_flow, np.flatnonzero(dead)).any()


def test_empty_flow_sets():
    z = np.zeros(0, np.int64)
    up = np.ones(3)
    assert tfs.maxmin_rates(z, z, up, up, device="cpu").shape == (0,)
    tm = tfs.transport(z, z, z, 1.0, up, up, device="cpu")
    assert tm.n_solves == 0 and tm.makespan == 0.0
    assert tm.chunk_flow.dtype == np.int64 and tm.chunk_end.size == 0


def test_fairshare_needs_a_device_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    src, dst, counts, up, down = _links(0, 6, 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfs.maxmin_rates(src, dst, up, down)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfs.transport(src, dst, counts, 1.0, up, down)


@pytest.mark.cuda
def test_fairshare_on_the_card_equal_to_plain_versions():
    """On a GPU, the solves in float64 on the card give the plain
    versions' bits (``chip_smoke.py`` holds them to 1e-9)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for seed, n, f, zero_cap, max_passes, qf in SEEDED:
        src, dst, counts, up, down = _links(seed, n, f, zero_cap)
        np.testing.assert_array_equal(
            tfs.maxmin_rates(src, dst, up, down, max_passes),
            tfs.maxmin_rates_plain(src, dst, up, down, max_passes))
        args = (src, dst, counts, 1000.0, up, down)
        _assert_timings(tfs.transport(*args, quantum_frac=qf),
                        tfs.transport_plain(*args, quantum_frac=qf))


def test_congestion_bound_and_pipeline_starts_equal():
    src, dst, counts, up, down = _links(7, 20, 100)
    nb = counts * 1000.0
    assert (tfs.congestion_bound(src, dst, nb, up, down)
            == jfs.congestion_bound(src, dst, nb, up, down))
    tm = jfs.transport(src, dst, counts, 1000.0, up, down)
    np.testing.assert_array_equal(
        tfs.pipeline_starts(tm.chunk_flow, tm.chunk_end),
        jfs.pipeline_starts(tm.chunk_flow, tm.chunk_end))


# ---------------------------------------------------------------------------
# whole event rounds
# ---------------------------------------------------------------------------

def _assert_round(j, t):
    """Two packages' event ``RoundResult``: the trace's integer columns
    and every integer metric exact, instants and seconds to RTOL/ATOL,
    the tracker's control log with its cycle ledger."""
    for k in LOG_INT_KEYS:
        np.testing.assert_array_equal(j.log[k], t.log[k], err_msg=k)
    for k in TIME_KEYS:
        np.testing.assert_allclose(t.log[k], j.log[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    for f in dataclasses.fields(j.metrics):
        a, b = getattr(j.metrics, f.name), getattr(t.metrics, f.name)
        if isinstance(a, (float, np.floating)):
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    for k in ("reconstructable", "active", "adj", "up", "down"):
        np.testing.assert_array_equal(getattr(j, k), getattr(t, k))
    jl, tl = dict(j.tracker_log), dict(t.tracker_log)
    assert jl.pop("cycles") == tl.pop("cycles")       # ints and instants
    assert jl.keys() == tl.keys()
    for k in jl:
        np.testing.assert_allclose(tl[k], jl[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _pair(cfg_kw, net_kw, sim_kw=None, run_kw=None):
    sim_kw, run_kw = dict(sim_kw or {}), run_kw or {}
    lm = sim_kw.pop("link_model", "RESIDENTIAL")
    js = JSim(JConfig(**cfg_kw), getattr(jcap, lm), time_engine="event",
              net=JNet(**net_kw), **sim_kw)
    ts = TSim(TConfig(**cfg_kw), getattr(tcap, lm), time_engine="event",
              net=TNet(**net_kw), device="cpu", **sim_kw)
    return js, js.run(**run_kw), ts, ts.run(**run_kw)


RESIDENTIAL_NET_KW = dict(tracker_rtt_s=0.1, latency_lo_s=0.005,
                          latency_hi_s=0.030)


@pytest.mark.parametrize("scheduler", ["greedy_fastest_first",
                                       "distributed"])
def test_event_round_residential_with_latency(scheduler):
    cfg = dict(n=40, chunks_per_update=24, min_degree=5, s_max=4000,
               seed=3, scheduler=scheduler)
    _, j, ts, t = _pair(cfg, RESIDENTIAL_NET_KW)
    _assert_round(j, t)
    assert t.log.t_start.max() > 0 and (t.log.t_end >= t.log.t_start).all()
    assert tprivacy.check_eq1(t.log, ts.cfg.owner_throttle, ts.cfg.k_gate)


def test_event_round_datacenter_solve_time():
    cfg = dict(n=24, chunks_per_update=64, chunk_bytes=4 << 20,
               min_degree=10, s_max=10**6, seed=0)
    _, j, _, t = _pair(cfg, dict(tracker_rtt_s=0.1, tracker_solve_s=0.6),
                       dict(link_model="DATACENTER", bt_mode="fluid"))
    _assert_round(j, t)
    assert t.fluid_bt and t.metrics.control_s > 0


def test_event_round_with_background_tail():
    """A carried background tail (two-phase solve over residual
    capacity) soaks this round's idle bandwidth identically."""
    cfg = dict(n=20, chunks_per_update=16, min_degree=5, s_max=4000,
               seed=4)
    # The tail: every chunk of peers 0 and 1, sent on to peers 5 to 9.
    snd = np.repeat([0, 1], 40)
    rcv = np.tile(np.repeat(np.arange(5, 10), 8), 2)
    bg = (snd, rcv, np.arange(snd.size))
    _, j, _, t = _pair(cfg, dict(tracker_rtt_s=0.05),
                       dict(background=bg, bt_mode="exact"))
    _assert_round(j, t)
    for k in ("meta", "src", "dst"):
        np.testing.assert_array_equal(j.bg_delivered[k], t.bg_delivered[k])
    for k in TIME_KEYS:
        np.testing.assert_allclose(t.bg_delivered[k], j.bg_delivered[k],
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(j.bg_remaining, t.bg_remaining)
    assert t.bg_delivered["meta"].size > 0


@pytest.mark.parametrize("tail_mode", ["carry", "drain"])
def test_event_round_quorum_cut_tail(tail_mode):
    cfg = dict(n=20, chunks_per_update=16, min_degree=5, s_max=4000,
               seed=2)
    _, j, _, t = _pair(cfg, RESIDENTIAL_NET_KW, dict(bt_mode="exact"),
                       dict(quorum_k=20, bt_budget=3, tail_mode=tail_mode))
    _assert_round(j, t)
    assert j.cut and t.cut
    for k in ("snd", "rcv", "chunk", "dead_owners", "ucols",
              "holder_mask"):
        np.testing.assert_array_equal(j.tail[k], t.tail[k])
    if tail_mode == "drain":
        np.testing.assert_allclose(t.drain_s, j.drain_s, rtol=RTOL,
                                   atol=ATOL)
        for k in ("snd", "rcv", "chunk", "slot"):
            np.testing.assert_array_equal(j.late[k], t.late[k])
        for k in TIME_KEYS:
            np.testing.assert_allclose(t.late[k], j.late[k], rtol=RTOL,
                                       atol=ATOL)
        assert t.drain_s > 0


def test_fig8_fast_pair_overhead():
    """Fig. 8's fast pair (``benchmarks/fig8_llm_scale.py --fast``'s
    Gemma-7B: n 24, K 3,338 pieces of 4 MiB, DATACENTER): BitTorrent
    only 369.0 s, FLTorrent 388.7 s, +5.33% in both packages."""
    chunk = 4 * 2**20
    K = int(-(-7e9 * 2 // chunk))
    common = dict(n=24, chunks_per_update=K, chunk_bytes=chunk,
                  s_max=10**7, seed=0, min_degree=10)
    base = dict(common, enable_gating=False, enable_preround=False,
                enable_timelag=False, enable_nonowner_first=False,
                warmup_threshold_pct=0.0)
    net = dict(tracker_rtt_s=0.1, tracker_solve_s=0.6)
    sim = dict(link_model="DATACENTER", bt_mode="fluid")
    _, jb, _, tb = _pair(base, net, sim)
    _, jf, _, tf = _pair(common, net, sim)
    _assert_round(jb, tb)
    _assert_round(jf, tf)
    b, f = tb.metrics.t_round_s, tf.metrics.t_round_s
    assert (round(b, 1), round(f, 1)) == (369.0, 388.7)
    assert round(100 * (f - b) / b, 2) == 5.33


def test_slot_and_event_schedules_equal():
    """bench_net.py's counts parity at a test size: the event engine
    issues the slot engine's schedule transfer for transfer."""
    kw = dict(n=24, chunks_per_update=16, min_degree=5, s_max=4000, seed=1)
    rs = TSim(TConfig(**kw)).run()
    re = TSim(TConfig(**kw), time_engine="event",
              net=TNet(tracker_rtt_s=0.0), device="cpu").run()
    for k in ("slot", "sender", "receiver", "chunk"):
        np.testing.assert_array_equal(rs.log[k], re.log[k])
    assert rs.metrics.t_warm == re.metrics.t_warm


# ---------------------------------------------------------------------------
# link validation and the capacity clamp
# ---------------------------------------------------------------------------

def test_event_engine_rejects_zero_rate_links():
    cfg = TConfig(n=8, chunks_per_update=4, min_degree=3, s_max=1000,
                  seed=0)
    up = np.ones(8, np.int64)
    with pytest.raises(ValueError, match="positive link rates"):
        TSim(cfg, up=up, down=up, up_bps=np.zeros(8),
             down_bps=np.ones(8) * 1e6, time_engine="event",
             device="cpu").run()


def test_clamp_warns_on_slot_engine_only():
    slow = tcap.LinkModel(up_lo=0.5 * tcap.MBPS, up_hi=0.6 * tcap.MBPS,
                          down_lo=50 * tcap.MBPS, down_hi=60 * tcap.MBPS)
    cfg = TConfig(n=12, chunks_per_update=8, min_degree=4, s_max=4000,
                  seed=0, enable_preround=False, enable_timelag=False,
                  enable_gating=False)
    with pytest.warns(RuntimeWarning, match="clamp binds"):
        TSim(cfg, slow)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = TSim(cfg, slow, time_engine="event",
                   net=TNet(tracker_rtt_s=0.0), device="cpu").run()
    # honest on clamped links: ~3.5 s a chunk against 1 chunk a slot
    assert res.metrics.t_round_s > 1.5 * res.metrics.t_round * cfg.slot_seconds


# ---------------------------------------------------------------------------
# time-domain bounds
# ---------------------------------------------------------------------------

def test_stage_time_lower_bound_equal():
    args = (np.zeros(4, np.int64), np.arange(1, 5), 10.0,
            np.array([5.0, 9, 9, 9, 9]), np.full(5, 100.0))
    assert tmaxflow.stage_time_lower_bound(*args) == 8.0
    src, dst, _, up, down = _links(8, 30, 200)
    for a in (args, (src, dst, 1000.0, up, down)):
        assert (tmaxflow.stage_time_lower_bound(*a)
                == jmaxflow.stage_time_lower_bound(*a))
    assert tmaxflow.stage_time_lower_bound(
        np.zeros(0, np.int64), np.zeros(0, np.int64), 1.0, up, down) == 0.0


def test_warmup_time_bounds_equal():
    cfg = dict(n=20, chunks_per_update=24, min_degree=5, s_max=4000,
               seed=2)
    js, j, ts, t = _pair(cfg, dict(tracker_rtt_s=0.0))
    jl, jr = jmaxflow.warmup_time_bounds(j.log, js.cfg.chunk_bytes,
                                         js.up_bps, js.down_bps)
    tl, tr = tmaxflow.warmup_time_bounds(t.log, ts.cfg.chunk_bytes,
                                         ts.up_bps, ts.down_bps)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tr, jr, rtol=RTOL, atol=ATOL)
    assert (tr >= tl - 1e-9).all() and tl.sum() > 0
