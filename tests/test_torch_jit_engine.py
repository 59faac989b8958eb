"""The port's GPU slot engine (``repro_torch.core.jit_engine``) against
the JAX package's jit engine, on the CPU.

The host boundary is a copy with the same numpy rng stream (two draws a
slot), so with JAX's own noise bases injected through the port's draw
hook (``_draw_bases``, drawn here exactly as ``repro/core/jit_engine.py``
draws them inside its kernel) the port is held byte for byte: the
bitplane helpers, every slot's grant grids (recorded from JAX rounds),
whole rounds and two-round sessions on both time engines.  With its own
bases (a CPU ``torch.Generator`` seeded by the slot's seed) the port is
held to the equivalence suite's rules instead: legality replay, Eq. 1,
three-way aggregate parity and the determinism twins
(tests/test_scheduler_equivalence.py).  Tests marked ``cuda`` hold the
slot kernels to their plain versions and the card's ``_slot_rounds`` to
the CPU's; they skip without a GPU.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                      # noqa: E402
import jax.numpy as jnp                                         # noqa: E402

from repro.core import SwarmConfig as JConfig                   # noqa: E402
from repro.core import SwarmSession as JSession                 # noqa: E402
from repro.core import jit_engine as jje                        # noqa: E402
from repro.core.simulator import RoundSimulator as JSim         # noqa: E402
from repro.net import NetConfig as JNet                         # noqa: E402

from repro_torch.core import SwarmConfig as TConfig             # noqa: E402
from repro_torch.core import SwarmSession as TSession           # noqa: E402
from repro_torch.core import jit_engine as tje                  # noqa: E402
from repro_torch.core import privacy                            # noqa: E402
from repro_torch.core import simulate_round as tsimulate        # noqa: E402
from repro_torch.core.simulator import RoundSimulator as TSim   # noqa: E402
from repro_torch.kernels import slots                           # noqa: E402
from repro_torch.net import NetConfig as TNet                   # noqa: E402
from test_scheduler_equivalence import _replay_legality         # noqa: E402

CPU = torch.device("cpu")
CENTRAL = ("random_fifo", "random_fastest_first", "greedy_fastest_first")
MODES = CENTRAL + ("distributed", "flooding")
LOG_KEYS = ("slot", "sender", "receiver", "chunk", "owner", "b_size",
            "o_size", "phase")
# the recorded rounds: the default one in full, two more warm-ups only;
# with the BT phase (ungated, no tiers) they cover all four plane
# layouts of stage 1
VARIANTS = {"default": {},
            "owner_tier_off": dict(enable_nonowner_first=False),
            "ungated": dict(enable_gating=False)}
WARMUP_ONLY = {"default": False, "owner_tier_off": True, "ungated": True}


def jax_bases(seed, n, d_pad):
    """The three noise bases as repro/core/jit_engine.py:398-402 draws
    them from the slot's seed, as the port's int32 words."""
    key = jax.random.PRNGKey(seed)
    k_noise, k_tie, k_prio = jax.random.split(key, 3)
    out = (jax.random.bits(k_noise, (n, d_pad), dtype=jnp.uint32),
           jax.random.bits(k_tie, (n,), dtype=jnp.uint32),
           jax.random.bits(k_prio, (n,), dtype=jnp.uint32))
    return tuple(torch.from_numpy(np.asarray(b).view(np.int32).copy())
                 for b in out)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tests run in several processes at once, and the planes here
    are small; torch's default of a thread a core in each would
    oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(tje, "_draw_bases", jax_bases)


def _i32(a) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int64).astype(np.uint32)


def _words(rng, shape):
    """Random uint32 words, dense and sparse rows, bit 31 set often."""
    w = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64)
    w = w.astype(np.uint32)
    w[::3] &= rng.integers(0, 2 ** 32, size=w[::3].shape,
                           dtype=np.uint64).astype(np.uint32)
    w[1::4] |= np.uint32(1 << 31)
    return w


# ---------------------------------------------------------------------------
# the bitplane helpers, exact
# ---------------------------------------------------------------------------

def test_mix32_and_popcount_are_exact():
    rng = np.random.default_rng(0)
    x = np.concatenate([_words(rng, (4096,)), np.array(
        [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)])
    want = np.asarray(jje._mix32(jnp.asarray(x)))
    got = tje._mix32(_i32(x))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(slots.popcount(_i32(x)).numpy(),
                                  np.bitwise_count(x).astype(np.int32))


def test_kth_set_bit_is_exact():
    rng = np.random.default_rng(1)
    w = _words(rng, (3000,))
    w = w[np.bitwise_count(w) > 0]
    k = (rng.random(w.size) * np.bitwise_count(w)).astype(np.int32)
    want = np.asarray(jje._kth_set_bit(jnp.asarray(w), jnp.asarray(k)))
    got = tje._kth_set_bit(_i32(w), torch.from_numpy(k))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,w,t_cap", [(37, 32, 64), (9, 8, 16),
                                       (5, 1, 8), (12, 64, 32)])
def test_rank_and_extraction_are_exact(n, w, t_cap):
    """``_rank_counts``, ``_extract_ranked`` (through ``_first_bits``)
    with rows whose ``want`` exceeds their popcount and empty rows."""
    rng = np.random.default_rng(n * w)
    rows = _words(rng, (n, w))
    rows[2] = 0
    want = rng.integers(0, t_cap + 8, size=n).astype(np.int32)
    want[0] = t_cap + 40
    jsb = np.asarray(jax.jit(jje._rank_counts)(jnp.asarray(rows)))
    tsb = tje._rank_counts(_i32(rows))
    np.testing.assert_array_equal(tsb.numpy(), jsb)
    jsel, jcols = jax.jit(jje._first_bits, static_argnums=2)(
        jnp.asarray(rows), jnp.asarray(want), t_cap)
    tsel, tcols = tje._first_bits(_i32(rows), torch.from_numpy(want), t_cap)
    np.testing.assert_array_equal(_u32(tsel), np.asarray(jsel))
    np.testing.assert_array_equal(tcols.numpy(), np.asarray(jcols))
    tsel2, tcols2 = tje._extract_ranked(_i32(rows), tsb,
                                        torch.from_numpy(want), t_cap)
    assert torch.equal(tsel2, tsel) and torch.equal(tcols2, tcols)


def _sims(n, k, **kw):
    cfg = dict(n=n, chunks_per_update=k, min_degree=min(4, n - 2),
               s_max=500, seed=5, scheduler_impl="jit", **kw)
    return JSim(JConfig(**cfg)), TSim(TConfig(**cfg), device="cpu")


@pytest.mark.parametrize("n,k", [(20, 16), (7, 40), (5, 64)])
def test_host_helpers_are_exact(n, k):
    """``_pack_words``, ``_diag_words``, ``_log_scatter``,
    ``_neighbor_lists`` and ``_sync_have_dev`` after the spray."""
    js, ts = _sims(n, k)
    js._spray()
    ts._spray()
    jst, tst = js.state, ts.state
    w_full = -(-jst.have.shape[1] // 32)
    np.testing.assert_array_equal(tje._pack_words(tst.have, w_full),
                                  jje._pack_words(jst.have, w_full))
    np.testing.assert_array_equal(tje._diag_words(tst, w_full),
                                  jje._diag_words(jst, w_full))
    nb = len(jst.log.receivers)
    for pos in (0, nb):
        for a, b in zip(jje._log_scatter(jst, pos, nb),
                        tje._log_scatter(tst, pos, nb)):
            np.testing.assert_array_equal(
                b.numpy().view(np.asarray(a).dtype), np.asarray(a))
    np.testing.assert_array_equal(tje._neighbor_lists(tst).numpy(),
                                  np.asarray(jje._neighbor_lists(jst)))
    want = np.asarray(jje._sync_have_dev(jst))
    np.testing.assert_array_equal(_u32(tje._sync_have_dev(tst)), want)
    np.testing.assert_array_equal(want, jje._pack_words(jst.have, w_full))


# ---------------------------------------------------------------------------
# recorded JAX slots, whole rounds and sessions, byte for byte
# ---------------------------------------------------------------------------

_ROUNDS: dict = {}


def _jax_round(mode, variant):
    """A JAX jit round (n 20, K 16) and every slot's kernel call:
    static arguments, inputs and (out_snd, out_col)."""
    key = (mode, variant)
    if key not in _ROUNDS:
        recorded = []
        orig = jje._compiled

        def recording(*static):
            kern = orig(*static)

            def run(*args):
                out = kern(*args)
                recorded.append((static, [np.asarray(a) for a in args],
                                 [np.asarray(o) for o in out]))
                return out
            return run

        cfg = JConfig(n=20, chunks_per_update=16, s_max=4000, seed=3,
                      scheduler=mode, scheduler_impl="jit",
                      **VARIANTS[variant])
        jje._compiled = recording
        try:
            res = JSim(cfg).run(warmup_only=WARMUP_ONLY[variant])
        finally:
            jje._compiled = orig
        _ROUNDS[key] = (res, recorded)
    return _ROUNDS[key]


def _replay(static, args, device):
    """One recorded slot through the port's ``_slot_rounds`` with JAX's
    bases, on ``device``; the grids as numpy."""
    (have, cand, owner, allowed, m, recv_ok, nbr, rem_up, rem_down,
     batch_cap, tau, seed) = args
    dev = torch.device(device)
    t = [_i32(a).to(dev) for a in (have, cand, owner)]
    out_snd, out_col, rounds = tje._slot_rounds(
        *static, *t, torch.from_numpy(np.array(allowed)).to(dev), int(m),
        torch.from_numpy(np.array(recv_ok)).to(dev), _i32(nbr).to(dev),
        _i32(rem_up).to(dev), _i32(rem_down).to(dev), int(batch_cap),
        int(tau), jax_bases(int(seed), nbr.shape[0], nbr.shape[1]))
    return out_snd.cpu().numpy(), out_col.cpu().numpy(), rounds


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mode", CENTRAL)
def test_recorded_slots_give_equal_grids(mode, variant):
    """Every slot of a JAX round, fed to the port's ``_slot_rounds``
    with JAX's bases: equal grant grids."""
    _, recorded = _jax_round(mode, variant)
    layouts = set()
    for static, args, (jsnd, jcol) in recorded:
        snd, col, rounds = _replay(static, args, "cpu")
        np.testing.assert_array_equal(snd, jsnd)
        np.testing.assert_array_equal(col, jcol)
        assert (jsnd[rounds:] == -1).all() and (jcol[rounds:] == -1).all()
        layouts.add(static[1:3])
    assert {"default": {(True, False), (False, True)},
            "owner_tier_off": {(False, False)},
            "ungated": {(True, True)}}[variant] == layouts


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mode", CENTRAL)
def test_whole_round_is_byte_identical(jax_draws, mode, variant):
    jres, _ = _jax_round(mode, variant)
    cfg = TConfig(n=20, chunks_per_update=16, s_max=4000, seed=3,
                  scheduler=mode, scheduler_impl="jit", **VARIANTS[variant])
    tres = TSim(cfg, device="cpu").run(warmup_only=WARMUP_ONLY[variant])
    for key in LOG_KEYS:
        np.testing.assert_array_equal(np.asarray(tres.log[key]),
                                      np.asarray(jres.log[key]), err_msg=key)
    assert tres.metrics.as_dict() == jres.metrics.as_dict()
    np.testing.assert_array_equal(tres.metrics.per_slot_warmup_util,
                                  jres.metrics.per_slot_warmup_util)


def _session_trace(pkg, time_engine):
    cfg_t, ses_t, net_t = ((JConfig, JSession, JNet) if pkg == "jax"
                           else (TConfig, TSession, TNet))
    cfg = cfg_t(n=20, chunks_per_update=16, min_degree=5, s_max=4000,
                seed=7, scheduler_impl="jit")
    kw = {} if pkg == "jax" else {"device": "cpu"}
    if time_engine == "event":
        kw.update(time_engine="event", net=net_t(tracker_rtt_s=0.05))
    ses = ses_t(cfg, churn_rate=0.1, **kw)
    ses.run(2)
    return ses.trace()


@pytest.mark.parametrize("time_engine", ["slot", "event"])
def test_session_is_byte_identical(jax_draws, time_engine):
    a = _session_trace("jax", time_engine)
    b = _session_trace("torch", time_engine)
    for key in LOG_KEYS:
        np.testing.assert_array_equal(np.asarray(b[key]), np.asarray(a[key]),
                                      err_msg=(time_engine, key))
    assert np.asarray(b.t_start).tobytes() == np.asarray(a.t_start).tobytes()
    assert np.asarray(b.t_end).tobytes() == np.asarray(a.t_end).tobytes()


# ---------------------------------------------------------------------------
# the equivalence suite's jit tests, on the port's own bases
# ---------------------------------------------------------------------------

def _cfg(mode, seed, impl, **kw):
    base = dict(n=16, chunks_per_update=24, s_max=5000, seed=seed,
                scheduler=mode, scheduler_impl=impl)
    base.update(kw)
    return TConfig(**base)


_PORT: dict = {}


def _port_round(mode, seed, impl):
    key = (mode, seed, impl)
    if key not in _PORT:
        _PORT[key] = tsimulate(_cfg(mode, seed, impl), device="cpu")
    return _PORT[key]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [1, 9])
def test_jit_schedules_legally(mode, seed):
    res = _port_round(mode, seed, "jit")
    _replay_legality(_cfg(mode, seed, "jit"), res,
                     check_tau=mode in CENTRAL)


@pytest.mark.parametrize("mode", MODES)
def test_jit_satisfies_eq1(mode):
    cfg = _cfg(mode, 3, "jit")
    res = _port_round(mode, 3, "jit")
    assert privacy.check_eq1(res.log, cfg.owner_throttle, cfg.k_gate)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [1, 9])
def test_three_way_aggregate_parity(mode, seed):
    rl = _port_round(mode, seed, "loop").metrics
    rj = _port_round(mode, seed, "jit").metrics
    assert not rj.failed_open
    assert abs(rj.t_warm - rl.t_warm) <= max(3, 0.6 * rl.t_warm)
    assert abs(rj.warmup_utilization - rl.warmup_utilization) <= 0.2
    assert abs(rj.t_round - rl.t_round) <= max(5, 0.35 * rl.t_round)
    rb = _port_round(mode, seed, "batched").metrics
    assert abs(rj.t_warm - rb.t_warm) <= max(3, 0.6 * rb.t_warm)
    assert abs(rj.warmup_utilization - rb.warmup_utilization) <= 0.2


@pytest.mark.parametrize("time_engine", ["slot", "event"])
def test_jit_determinism_twin(time_engine):
    """A fixed seed replays a byte-identical multi-round trace on the
    port's own bases, on both time engines."""
    a = _session_trace("torch", time_engine)
    b = _session_trace("torch", time_engine)
    for key in LOG_KEYS:
        assert np.array_equal(a[key], b[key]), (time_engine, key)
    assert np.array_equal(a.t_start, b.t_start)
    assert np.array_equal(a.t_end, b.t_end)


def test_bases_come_from_the_slot_seed():
    """``_draw_bases`` is a CPU generator's stream of the seed: the same
    words for the same seed, whatever the device asked for later."""
    a = tje._draw_bases(12345, 20, 8)
    b = tje._draw_bases(12345, 20, 8)
    c = tje._draw_bases(12346, 20, 8)
    assert [t.shape for t in a] == [(20, 8), (20,), (20,)]
    assert all(t.dtype == torch.int32 and t.device == CPU for t in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert bool((a[0] < 0).any())              # bit 31 is drawn too


def test_jit_engine_refuses_the_cpu_without_a_device():
    """No GPU and no ``device``: the jit engine raises from
    ``resolve_device``; it never falls back to the CPU or to batched."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    cfg = _cfg("greedy_fastest_first", 1, "jit")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsimulate(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSession(cfg)
    sim = TSim(_cfg("greedy_fastest_first", 1, "batched"))
    sim.state.cfg = cfg                 # a state no simulator placed
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tje.schedule_centralized_jit(sim.state, "greedy_fastest_first")


def test_phase_timers_and_counts():
    ticks = iter(range(10_000))
    tje.reset_counts()
    from repro_torch.core.simulator import measured_clock
    with measured_clock(lambda: float(next(ticks))):
        assert tje._clock is not tje._zero_clock
        tje.reset_phase_timers()
        tsimulate(_cfg("random_fifo", 2, "jit"), device="cpu",
                  warmup_only=True)
        held = tje.reset_phase_timers()
    assert tje._clock is tje._zero_clock
    counts = tje.reset_counts()
    assert all(v > 0 for v in held.values())
    assert counts["slots"] > 0
    assert counts["host_reads"] == counts["rounds"] + counts["slots"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _load_smoke():
    """``chip_smoke.py`` from the repo root, whose ``check_small_slots``
    is the one builder of the slot kernels' cases."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load_smoke()


@pytest.mark.cuda
@pytest.mark.parametrize("case", SMOKE.SLOT_CASES)
def test_cuda_slot_kernels_match_plain_versions(case):
    """Each slot kernel exactly equal to its plain version on one of
    ``chip_smoke.SLOT_CASES``, in every plane layout."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    SMOKE.check_small_slots("cuda", [case])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", CENTRAL)
def test_cuda_slot_rounds_match_the_cpu(mode):
    """Every recorded slot of the default round: the card's
    ``_slot_rounds`` (the slot kernels) equals the CPU's (the plain
    versions), given the same bases."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    _, recorded = _jax_round(mode, "default")
    for static, args, _ in recorded:
        a = _replay(static, args, "cpu")
        b = _replay(static, args, "cuda")
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])
        assert a[2] == b[2]
