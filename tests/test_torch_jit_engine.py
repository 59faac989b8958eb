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
(tests/test_scheduler_equivalence.py).  The port keeps its device
inventory chunk-major (one row a chunk) where the JAX package keeps it
row-major, so JAX's words are turned around exactly (``_chunk_major``)
wherever they are fed to the port.  The ``slot_planes`` kernel's tile
transpose, owner ballots, split and count merge, and the
``slot_rounds`` kernel's sender phase (which walks each sender's
in-neighbor list where the plain loop sorts globally,
``slots.grouped_take``), have numpy models here held equal to the plain
versions on recorded and on hypothesis-drawn inputs.  Tests marked ``cuda`` hold the slot kernels
to their plain versions and the card's ``_slot_rounds`` to the CPU's
and to the plain loop on the card; they skip without a GPU.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

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


def _load_smoke():
    """``chip_smoke.py`` from the repo root, whose ``check_small_slots``
    and ``slot_case`` are the one builder of the slot kernels'
    cases."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load_smoke()


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


def _chunk_major(words, n: int, rows: int | None = None) -> np.ndarray:
    """The JAX package's row-major (n, w) uint32 inventory words as the
    port's chunk-major (32 w, _n_wp(n)) words (the first ``rows`` rows),
    exactly: unpacked to bits, transposed, packed again."""
    words = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    bits = np.unpackbits(words.view(np.uint8), axis=1, bitorder="little")
    return tje._pack_words(bits.T[:rows], tje._n_wp(n))


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


def _scattered(operands, shape) -> np.ndarray:
    """Zero words of ``shape`` with scatter operands (rows, word column,
    bit value) added in, as the engine's ``_scatter_bits`` adds them."""
    rows, wcol, vals = (np.asarray(a) for a in operands)
    out = np.zeros(shape, np.uint64)
    np.add.at(out, (rows.astype(np.int64), wcol.astype(np.int64)),
              vals.view(np.uint32).astype(np.uint64))
    return out.astype(np.uint32)


@pytest.mark.parametrize("n,k", [(20, 16), (7, 40), (5, 64)])
def test_host_helpers_are_exact(n, k):
    """``_pack_words``, ``_diag_words``, ``_log_scatter``,
    ``_neighbor_lists`` and ``_sync_have_dev`` after the spray; the JAX
    package's row-major words turned chunk-major (``_chunk_major``)."""
    js, ts = _sims(n, k)
    js._spray()
    ts._spray()
    jst, tst = js.state, ts.state
    universe = jst.have.shape[1]
    w_full = -(-universe // 32)
    n_wp = tje._n_wp(n)
    np.testing.assert_array_equal(tje._pack_words(tst.have, w_full),
                                  jje._pack_words(jst.have, w_full))
    np.testing.assert_array_equal(
        _u32(tje._diag_words(tst, "cpu")),
        _chunk_major(jje._diag_words(jst, w_full), n, universe))
    nb = len(jst.log.receivers)
    for pos in (0, nb):
        j_ops = jje._log_scatter(jst, pos, nb)
        t_ops = tje._log_scatter(tst, pos, nb)
        assert [a.shape for a in t_ops] == [np.asarray(a).shape
                                            for a in j_ops]
        np.testing.assert_array_equal(
            _scattered(t_ops, (universe, n_wp)),
            _chunk_major(_scattered(j_ops, (n, w_full)), n, universe))
    np.testing.assert_array_equal(tje._neighbor_lists(tst).numpy(),
                                  np.asarray(jje._neighbor_lists(jst)))
    want = np.asarray(jje._sync_have_dev(jst))
    np.testing.assert_array_equal(_u32(tje._sync_have_dev(tst)),
                                  _chunk_major(want, n, universe))
    np.testing.assert_array_equal(want, jje._pack_words(jst.have, w_full))


def _packbits_t(have: np.ndarray) -> np.ndarray:
    """``np.packbits`` of ``have.T`` into (universe, _n_wp(n)) uint32."""
    n = have.shape[0]
    p = np.packbits(have.T, axis=1, bitorder="little")
    buf = np.zeros((have.shape[1], tje._n_wp(n) * 4), np.uint8)
    buf[:, :p.shape[1]] = p
    return buf.view("<u4").astype(np.uint32)


@pytest.mark.parametrize("n,k", [(37, 5), (50, 6), (7, 40), (33, 8)])
def test_chunk_major_inventory_is_packbits_of_have_t(n, k):
    """The chunk-major helpers against ``np.packbits`` of ``have.T`` at n
    not a multiple of 32: the owner diagonal before the spray, the
    operands of the spray's log, ``_sync_have_dev`` built before the
    spray and replayed after it, and the full repack of a swapped
    ``have``; the bits of peers at or above n stay zero."""
    sim = TSim(TConfig(n=n, chunks_per_update=k, min_degree=min(4, n - 2),
                       s_max=500, seed=5, scheduler_impl="jit"),
               device="cpu")
    st = sim.state
    assert tje._n_wp(n) % 8 == 0 and tje._n_wp(n) * 32 >= n
    np.testing.assert_array_equal(_u32(tje._diag_words(st, "cpu")),
                                  _packbits_t(st.have))
    np.testing.assert_array_equal(_u32(tje._sync_have_dev(st)),
                                  _packbits_t(st.have))
    before = st.have.copy()
    nb0 = len(st.log.receivers)
    sim._spray()
    nb = len(st.log.receivers)
    assert nb > nb0
    np.testing.assert_array_equal(
        _u32(tje._diag_words(st, "cpu"))
        | _scattered(tje._log_scatter(st, nb0, nb),
                     _packbits_t(before).shape),
        _packbits_t(st.have))
    got = _u32(tje._sync_have_dev(st))
    np.testing.assert_array_equal(got, _packbits_t(st.have))
    pad = np.arange(tje._n_wp(n) * 32) >= n
    bits = np.unpackbits(got.view(np.uint8), axis=1, bitorder="little")
    assert not bits[:, pad].any()
    st.have = st.have.copy()                  # a swapped identity
    st.have[0, -1] = True
    np.testing.assert_array_equal(_u32(tje._sync_have_dev(st)),
                                  _packbits_t(st.have))


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


def _replay(static, args, device, impl="cuda"):
    """One recorded slot through the port's ``_slot_rounds`` with JAX's
    bases, on ``device``; the grids as numpy."""
    (have, cand, owner, allowed, m, recv_ok, nbr, rem_up, rem_down,
     batch_cap, tau, seed) = args
    dev = torch.device(device)
    have_t = _chunk_major(have, nbr.shape[0])
    t = [_i32(a).to(dev) for a in (have_t, cand, owner)]
    out_snd, out_col, rounds = tje._slot_rounds(
        *static, *t, torch.from_numpy(np.array(allowed)).to(dev), int(m),
        torch.from_numpy(np.array(recv_ok)).to(dev), _i32(nbr).to(dev),
        _i32(rem_up).to(dev), _i32(rem_down).to(dev), int(batch_cap),
        int(tau), jax_bases(int(seed), nbr.shape[0], nbr.shape[1]),
        _i32(tje._transpose_lists(np.asarray(nbr))).to(dev), impl=impl)
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
# slot_rounds' sender phase: the in-neighbor walk against the global sort
# ---------------------------------------------------------------------------

def group_walk(in_nbr, u_v, req, recv_prio, is_new, recv_slots, rem_up):
    """The ``slot_rounds`` kernel's sender phase (``csrc/slots.cu::
    sender_split``) in numpy.  Each sender u walks its in-neighbor list
    and takes as its group the rows paired with it (``u_v[v] == u``),
    in ascending ``(recv_prio + 0.0, v)`` order (Python compares -0.0
    and +0.0 equal, as the kernel's float compare does).  Each member
    is ranked by counting the members before it: the first
    ``recv_slots[u]`` new pairs pass the tau gate, and each grant is
    capped at what ``rem_up[u]`` leaves after the gated requests before
    it.  Returns the grants and u's budgets after them."""
    n = len(u_v)
    take = np.zeros(n, np.int64)
    up_after = rem_up.astype(np.int64).copy()
    slots_after = recv_slots.astype(np.int64).copy()
    for u in range(n):
        group = [int(v) for v in in_nbr[u] if v >= 0 and u_v[v] == u]
        keyed = [(float(recv_prio[v]) + 0.0, v) for v in group]

        def before(a, b):
            return a[0] < b[0] or (a[0] == b[0] and a[1] < b[1])
        gated = {}
        for me in keyed:
            new_rank = sum(1 for o in keyed if is_new[o[1]]
                           and before(o, me))
            v = me[1]
            gated[v] = (int(req[v]) if not is_new[v]
                        or new_rank < recv_slots[u] else 0)
        for me in keyed:
            v = me[1]
            excl = sum(gated[o[1]] for o in keyed if before(o, me))
            take[v] = min(gated[v], max(int(rem_up[u]) - excl, 0))
            up_after[u] -= take[v]
            slots_after[u] -= int(take[v] > 0 and is_new[v])
    return take, up_after, slots_after


def _hold_group_walk(nbr, u_v, req, recv_prio, is_new, recv_slots, rem_up):
    """``slots.grouped_take`` (the plain loop's global sort) and the
    plain loop's budget updates against ``group_walk`` on the port's
    in-neighbor lists of ``nbr``, exactly."""
    n = len(u_v)
    want = slots.grouped_take(
        torch.from_numpy(u_v.astype(np.int64)), torch.from_numpy(req),
        torch.from_numpy(recv_prio), torch.from_numpy(is_new),
        torch.from_numpy(recv_slots), torch.from_numpy(rem_up), n).numpy()
    take, up_after, slots_after = group_walk(
        tje._transpose_lists(nbr), u_v, req, recv_prio, is_new, recv_slots,
        rem_up)
    np.testing.assert_array_equal(take, want)
    u_c = np.minimum(u_v, n - 1)
    granted = want > 0
    np.testing.assert_array_equal(
        up_after, rem_up - np.bincount(u_c[granted], want[granted],
                                       minlength=n).astype(np.int64))
    np.testing.assert_array_equal(
        slots_after, recv_slots - np.bincount(u_c[granted & is_new],
                                              minlength=n))
    return int(granted.sum())


def _transpose_by_hand(nbr):
    n = nbr.shape[0]
    return [sorted(v for v in range(n) if u in set(nbr[v][nbr[v] >= 0]))
            for u in range(n)]


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mode", CENTRAL)
def test_group_walk_matches_the_global_sort_on_recorded_rounds(
        monkeypatch, mode, variant):
    """Every grant round of every recorded slot (JAX's bases): the
    kernel's in-neighbor walk gives the plain loop's grants."""
    _, recorded = _jax_round(mode, variant)
    rounds = []
    orig = slots.grouped_take

    def recording(*a):
        rounds.append([t.clone().numpy() for t in a[:6]])
        return orig(*a)

    granted = 0
    for static, args, _ in recorded:
        nbr = np.asarray(args[6])
        in_nbr = tje._transpose_lists(nbr)
        assert [sorted(r[r >= 0]) for r in in_nbr] == \
            _transpose_by_hand(nbr)
        rounds.clear()
        with monkeypatch.context() as m:
            m.setattr(slots, "grouped_take", recording)
            _replay(static, args, "cpu")
        assert rounds
        for u_v, req, prio, isn, slots_u, up in rounds:
            granted += _hold_group_walk(nbr, u_v, req, prio, isn, slots_u,
                                        up)
    assert granted > 0


@settings(max_examples=150, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2 ** 32 - 1), n=st.integers(1, 24),
       symmetric=st.booleans(), paired=st.floats(0.0, 1.0),
       prio=st.sampled_from(["ties", "signed zeros", "distinct"]))
def test_group_walk_matches_the_global_sort_on_drawn_rounds(
        seed, n, symmetric, paired, prio):
    """Drawn rounds: overlays symmetric or not (with rows and columns
    left empty), unpaired rows (all -inf), senders no one picked, ties
    in recv_prio, -0.0 beside +0.0, zero budgets and requests."""
    g = np.random.default_rng(seed)
    adj = g.random((n, n)) < g.uniform(0.0, 0.7)
    if symmetric:
        adj |= adj.T
    np.fill_diagonal(adj, False)
    deg = adj.sum(1)
    nbr = np.full((n, tje._pow2(max(int(deg.max(initial=1)), 1))), -1,
                  np.int32)
    u_v = np.full(n, n, np.int64)
    for v in range(n):
        row = g.permutation(np.flatnonzero(adj[v]))
        nbr[v, :row.size] = row
        if row.size and g.random() < paired:
            u_v[v] = g.choice(row)
    if prio == "ties":
        recv_prio = g.choice(np.float32([-1.5, 0.25, 0.25, 3.0]), n)
    elif prio == "signed zeros":
        recv_prio = g.choice(np.float32([-0.0, 0.0, 0.5]), n)
    else:
        recv_prio = g.standard_normal(n).astype(np.float32)
    req = np.where(u_v < n, g.integers(0, 12, n), 0).astype(np.int32)
    is_new = (u_v < n) & (g.random(n) < 0.6)
    recv_slots = g.integers(0, 4, n).astype(np.int32)
    rem_up = g.integers(0, 30, n).astype(np.int32)
    _hold_group_walk(nbr, u_v, req, recv_prio.astype(np.float32), is_new,
                     recv_slots, rem_up)


# ---------------------------------------------------------------------------
# slot_planes' tiles: the butterfly transpose and the owner ballots
# ---------------------------------------------------------------------------

_LANE = np.arange(32)
_BUTTERFLY = ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F),
              (2, 0x33333333), (1, 0x55555555))


def transpose32(x):
    """``csrc/slots.cu::transpose32`` over the last axis (the 32 lanes
    of a warp): five ``__shfl_xor_sync`` block swaps."""
    x = x.astype(np.uint32)
    for j, m in _BUTTERFLY:
        m = np.uint32(m)
        y = x[..., _LANE ^ j]
        x = np.where((_LANE & j) != 0, (x & ~m) | ((y >> j) & m),
                     (x & m) | ((y << j) & ~m))
    return x


def _ballot(pred):
    """``__ballot_sync`` over the last axis: bit l set where lane l's
    predicate holds."""
    return (pred.astype(np.uint64) << _LANE.astype(np.uint64)).sum(
        -1).astype(np.uint32)


def planes_model(have_t, cand, owner, allowed, recv_ok, m_cnt, *,
                 nonowner, ungated):
    """``csrc/slots.cu::slot_planes_kernel`` in numpy, tile by tile: CTA
    (x, y) builds ``wb = min(PLANE_WORDS, W)`` words (the launcher's
    choice) of 256 receivers; warp rb of it loads, lane l, candidate
    l's have_t word rb (zero for pad candidates),
    turns the tile around with ``transpose32``, marks the owner cells of
    the lanes whose owner lies in block rb (the ballot loop), and leaves
    its rows' counts as partial words (need count | sup << 30) that the
    ticket's last CTA sums."""
    n = recv_ok.size
    m_pad = cand.size
    w = m_pad // 32
    wb = min(slots.PLANE_WORDS, w)
    n_rb = -(-n // 32)
    valid = np.arange(m_pad) < m_cnt
    x = np.where(valid[:, None], have_t[cand].view(np.uint32), 0)
    tiles = x[:, :n_rb].T.reshape(n_rb, w, 32)         # (rb, word, lane)
    hv = transpose32(tiles)                            # lane r: receiver r
    vmask = _ballot(valid.reshape(w, 32))[None, :, None]
    alw = _ballot((valid & allowed).reshape(w, 32))[None, :, None]
    rb = np.arange(n_rb)[:, None, None]
    ow = np.where(valid, owner, -1).reshape(1, w, 32)
    ownr = np.where((ow >= 0) & (ow >> 5 == rb), ow & 31, -1)
    own = np.zeros_like(hv)
    for j in range(32):                                # the hits loop
        r_i, w_i = np.nonzero(ownr[:, :, j] >= 0)
        own[r_i, w_i, ownr[r_i, w_i, j]] |= np.uint32(1 << j)
    sup = hv if ungated else (hv & ~own) | (hv & own & alw)
    rok = np.concatenate([recv_ok, np.zeros(n_rb * 32 - n, bool)])
    nd = np.where(rok.reshape(n_rb, 1, 32), ~hv & vmask, np.uint32(0))

    def rows(t):                                       # (n, w) words
        return t.transpose(0, 2, 1).reshape(n_rb * 32, w)[:n]
    plane_a = rows(sup & ~own if nonowner else sup)
    plane_b = rows(sup & own) if nonowner else None
    cnt_n = np.bitwise_count(nd).reshape(n_rb, w // wb, wb, 32).sum(2)
    cnt_s = np.bitwise_count(sup).reshape(n_rb, w // wb, wb, 32).sum(2)
    part = cnt_n.astype(np.int64) | np.where(cnt_s > 0, 1 << 30, 0)
    part = part.transpose(1, 0, 2).reshape(w // wb, n_rb * 32)[:, :n]
    need_cnt = (part & 0x3FFFFFFF).sum(0)
    sup_any = (part >> 30).any(0)
    return plane_a, plane_b, rows(nd), need_cnt, sup_any


def _hold_planes_model(host, m_cnt):
    have_t, cand, owner, allowed, recv_ok = (t.numpy() for t in host)
    layouts = 0
    for nonowner in (True, False):
        for ungated in (True, False):
            kw = dict(nonowner=nonowner, ungated=ungated)
            want = slots.slot_planes_plain(*host, m_cnt, **kw)
            got = planes_model(have_t, cand, owner, allowed, recv_ok, m_cnt,
                               **kw)
            for g, w in zip(got[:3], want[:3]):
                assert (g is None) == (w is None)
                if w is not None:
                    np.testing.assert_array_equal(g, _u32(w))
            np.testing.assert_array_equal(got[3], want[3].numpy())
            np.testing.assert_array_equal(got[4], want[4].numpy())
            layouts += 1
    return layouts


def test_transpose32_is_the_ballot_transpose():
    """The butterfly gives lane r the word that 32 ballots of bit r
    give, on random tiles and on single bits."""
    rng = np.random.default_rng(3)
    single = (_LANE[None, :] + _LANE[:, None]) % 32   # one bit a lane
    x = np.concatenate([_words(rng, (64, 32)),
                        np.uint32(1) << single.astype(np.uint32)])
    want = np.stack([_ballot((x >> np.uint32(r)) & 1) for r in range(32)],
                    axis=-1)
    np.testing.assert_array_equal(transpose32(x), want)


@pytest.mark.parametrize("case", SMOKE.SLOT_CASES)
def test_planes_model_matches_the_plain_version(case):
    """The numpy model of ``slot_planes_kernel`` equal to
    ``slot_planes_plain`` on ``chip_smoke.SLOT_CASES``' inputs (garbage
    in the bits of peers at or above n, pad candidates with owner 0) in
    every plane layout; the cases' W of 1, 2, 4, 8 and 256 words run
    every width of CTA and rows whose counts span CTAs."""
    host = SMOKE.slot_case(case, np.random.default_rng(case[0] * case[1]))
    assert _hold_planes_model(host, case[2]) == 4


@settings(max_examples=60, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2 ** 32 - 1), n=st.integers(1, 700),
       w_log=st.integers(0, 5), fill=st.floats(0.0, 1.0))
def test_planes_model_matches_the_plain_version_on_drawn_slots(
        seed, n, w_log, fill):
    """Drawn shapes: n up to 700 (partial receiver blocks and groups),
    W from 1 to 32 words (1 to 8 words a CTA, 1 to 4 CTAs a row), any
    count of real candidates (none to all)."""
    m_pad = 32 << w_log
    m_cnt = int(fill * m_pad)
    w_full = max(-(-m_pad // 32), 1) + 3
    host = SMOKE.slot_case((n, m_pad, m_cnt, w_full),
                           np.random.default_rng(seed))
    _hold_planes_model(host, m_cnt)


def test_in_neighbor_lists_follow_the_overlay():
    """The neighbor lists and their transpose are cached on the state
    and rebuilt when ``state.adj`` is replaced; the transpose assumes no
    symmetry."""
    sim = TSim(_cfg("greedy_fastest_first", 1, "jit"), device="cpu")
    state = sim.state
    nbr, in_nbr = tje._overlay_lists(state)
    assert tje._neighbor_lists(state) is nbr
    assert tje._overlay_lists(state)[1] is in_nbr
    n = state.adj.shape[0]
    for adj, lists, rows in ((state.adj, nbr, True),
                             (state.adj, in_nbr, False)):
        for i in range(n):
            got = lists[i].numpy()
            want = np.flatnonzero(adj[i] if rows else adj[:, i])
            assert sorted(got[got >= 0]) == list(want)
    g = np.random.default_rng(4)
    adj = g.random((n, n)) < 0.3
    adj[:, 0] = False                   # no one lists peer 0
    np.fill_diagonal(adj, False)
    assert not (adj == adj.T).all()
    state.adj = adj
    nbr2, in2 = tje._overlay_lists(state)
    assert nbr2 is not nbr and in2 is not in_nbr
    for i in range(n):
        got = nbr2[i].numpy()
        assert sorted(got[got >= 0]) == list(np.flatnonzero(adj[i]))
        got = in2[i].numpy()
        assert sorted(got[got >= 0]) == list(np.flatnonzero(adj[:, i]))
    assert (in2[0] == -1).all()


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
    # the CPU runs the plain loop: a read a round, plus the grids
    assert counts["host_reads"] == counts["rounds"] + counts["slots"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

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


@pytest.mark.cuda
@pytest.mark.parametrize("case", SMOKE.SLOT_CASES)
def test_cuda_slot_rounds_match_the_plain_loop(case):
    """The ``slot_rounds`` kernel exactly equal to ``slot_rounds_plain``
    on the card, on seeded random slots of one of
    ``chip_smoke.SLOT_CASES``' sizes: every mode, plane layout and
    overlay and base variant (``chip_smoke.random_slot``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    assert SMOKE.check_small_slot_rounds("cuda", [case]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mode", CENTRAL)
def test_cuda_slot_rounds_match_the_plain_loop_on_recorded_slots(
        mode, variant):
    """Every recorded slot: ``_slot_rounds`` on the card through the
    kernels equals the plain loop on the card (``impl="torch"``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    _, recorded = _jax_round(mode, variant)
    for static, args, _ in recorded:
        a = _replay(static, args, "cuda", impl="torch")
        b = _replay(static, args, "cuda")
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])
        assert a[2] == b[2]
