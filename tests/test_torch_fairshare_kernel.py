"""The fair-share kernels (``repro_torch.kernels.fairshare``).

On the CPU the wrappers run their plain version, the torch loop kept
beside the kernels, which is held here to the JAX package's
compiled solvers, ``_maxmin_jax`` (``_maxmin_compiled``, one
``lax.while_loop`` over bottleneck levels) and ``_transport_jax``
(``_transport_compiled``, the whole segment loop in one
``lax.while_loop``): rates and instants to ``rtol = atol = 1e-9``,
``chunk_flow`` and ``n_solves`` exact.  Under jax 0.9 the JAX module's
own ``from jax.experimental import enable_x64`` fails and it runs its
host loops instead, so the fixture below hands it ``jax.enable_x64``,
as a jax that has the old name would; nothing in ``src/repro/``
changes.

Tests marked ``cuda`` need a card: there the kernels, and the torch
loop on the card, must give the numpy plain versions' bits, one launch
a call; a call past the shared-memory limit raises ``ValueError`` and a
call cut by the segment watchdog raises ``RuntimeError``.  This file
imports JAX only inside the fixture, so the card's tests run where JAX
is not installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import LAUNCHES, reset_launches   # noqa: E402
from repro_torch.kernels import fairshare as kfs           # noqa: E402
from repro_torch.net import fairshare as tfs               # noqa: E402

RTOL = ATOL = 1e-9
CPU = torch.device("cpu")

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
# tests/test_torch_net.py's seeded cases: (seed, n, f, zero_cap,
# max_passes, quantum_frac)
SEEDED = [
    (0, 12, 60, False, 16, 1 / 64),
    (1, 30, 200, False, 1, 1 / 64),
    (2, 40, 300, True, 16, 1 / 64),
    (3, 20, 120, False, 2, 0.0),
    (4, 60, 400, True, 2, 1 / 32),
    (5, 2, 10, False, 16, 0.0),
    (6, 25, 150, False, 16, 1 / 32),
]
WIDE_CHUNK = float(4 * 2**20)           # Fig. 8's 4 MiB pieces


def _seeded(seed, n, f, zero_cap=False):
    """tests/test_torch_net.py's ``_links``: seeded links over six
    decades, flows without self-loops, chunk counts 1 to 8."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, f)
    dst = (src + 1 + rng.integers(0, n - 1, f)) % n
    up = rng.uniform(1.0, 50.0, n) * 10.0 ** rng.integers(0, 6, n)
    down = rng.uniform(1.0, 50.0, n) * 10.0 ** rng.integers(0, 6, n)
    if zero_cap:
        up[src[0]] = 0.0
        down[dst[-1]] = 0.0
    return src, dst, rng.integers(1, 9, f), up, down


def _wide():
    """n 50, 500 flows of 1 to 131 chunks (about 33,000), 4 MiB pieces
    over DATACENTER's 7 to 10 Gbit/s links."""
    rng = np.random.default_rng(50)
    n, f = 50, 500
    src = rng.integers(0, n, f)
    dst = (src + 1 + rng.integers(0, n - 1, f)) % n
    up = rng.uniform(7.0, 10.0, n) * 1e9 / 8
    down = rng.uniform(7.0, 10.0, n) * 1e9 / 8
    return src, dst, rng.integers(1, 132, f), up, down


def _transport_cases():
    """(src, dst, counts, chunk_bytes, up, down, quantum_frac)."""
    cases = [tuple(np.asarray(x) for x in c[:3]) + (c[3],)
             + tuple(np.asarray(x) for x in c[4:]) + (1 / 64,)
             for c in TRANSPORT_SMALL]
    for seed, n, f, zero_cap, _, qf in SEEDED:
        src, dst, counts, up, down = _seeded(seed, n, f, zero_cap)
        cases.append((src, dst, counts, 1000.0, up, down, qf))
    src, dst, counts, up, down = _wide()
    cases.append((src, dst, counts, WIDE_CHUNK, up, down, 1 / 64))
    return cases


def _maxmin_cases():
    """(src, dst, up, down, max_passes)."""
    cases = [tuple(np.asarray(x) for x in c) + (16,) for c in MAXMIN_SMALL]
    for seed, n, f, zero_cap, mp, _ in SEEDED:
        src, dst, _, up, down = _seeded(seed, n, f, zero_cap)
        cases.append((src, dst, up, down, mp))
    return cases


TRANSPORT_CASES = _transport_cases()
MAXMIN_CASES = _maxmin_cases()


@pytest.fixture
def jfs(monkeypatch):
    """The JAX package's ``repro.net.fairshare`` with ``enable_x64``
    bound, so its compiled solvers run in float64."""
    jax = pytest.importorskip("jax")
    from repro.net import fairshare
    monkeypatch.setattr(fairshare, "enable_x64", jax.enable_x64,
                        raising=False)
    return fairshare


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


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


# ---------------------------------------------------------------------------
# the plain route against JAX's compiled solvers (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(len(MAXMIN_CASES)))
def test_maxmin_torch_loop_matches_maxmin_compiled(jfs, case):
    src, dst, up, down, mp = MAXMIN_CASES[case]
    want = jfs._maxmin_jax(src, dst, up, down, mp)
    got = kfs.fairshare_maxmin(src, dst, up, down, mp, device=CPU,
                               impl="torch")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        got, tfs.maxmin_rates(src, dst, up, down, mp, device="cpu"))


@pytest.mark.parametrize("case", range(len(TRANSPORT_CASES)))
def test_transport_torch_loop_matches_transport_compiled(jfs, case):
    src, dst, counts, cb, up, down, qf = TRANSPORT_CASES[case]
    s, d, c, nbytes, u, w, quantum = tfs._flows(src, dst, counts, cb, up,
                                                down, qf)
    want = jfs._transport_jax(s, d, c, nbytes, cb, u, w, quantum)
    got = tfs.transport(src, dst, counts, cb, up, down, quantum_frac=qf,
                        device="cpu")
    _assert_timings(got, want)
    assert (np.bincount(got.chunk_flow, minlength=len(src))
            <= counts).all()
    # The watchdog's default cap rests on this: a segment finishes a
    # flow or drops the dead ones, so a call runs at most F segments.
    assert got.n_solves <= len(src) < kfs.watchdog_segments(len(src))


def test_wrappers_refuse_an_unknown_impl():
    src, dst, counts, up, down = _seeded(0, 6, 10)
    with pytest.raises(ValueError, match="unknown fairshare_maxmin impl"):
        kfs.fairshare_maxmin(src, dst, up, down, device=CPU, impl="xla")
    with pytest.raises(ValueError, match="unknown fairshare_transport"):
        kfs.fairshare_transport(src, dst, counts, counts * 1.0, 1.0, up,
                                down, 0.0, device=CPU, impl="xla")


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_cuda_solvers_bit_equal_to_the_plain_versions(impl):
    """The kernels (``impl="cuda"``) and the torch loop on the card
    (``impl="torch"``) give the numpy plain versions' bits: the rates,
    the finish instants, the chunk ends of the crossed chunks and the
    solve count; the kernels also through ``maxmin_rates`` and
    ``transport``."""
    _needs_card()
    card = torch.device("cuda")
    for src, dst, up, down, mp in MAXMIN_CASES:
        want = tfs.maxmin_rates_plain(src, dst, up, down, mp)
        np.testing.assert_array_equal(
            kfs.fairshare_maxmin(*tfs._links(src, dst, up, down), mp,
                                 device=card, impl=impl), want)
        if impl == "cuda":
            np.testing.assert_array_equal(
                tfs.maxmin_rates(src, dst, up, down, mp), want)
    for src, dst, counts, cb, up, down, qf in TRANSPORT_CASES:
        args = (src, dst, counts, cb, up, down)
        want = tfs.transport_plain(*args, quantum_frac=qf)
        s, d, c, nbytes, u, w, quantum = tfs._flows(*args, qf)
        finish, cend, n_solves = kfs.fairshare_transport(
            s, d, c, nbytes, cb, u, w, quantum, device=card, impl=impl)
        crossed = np.isfinite(cend)
        np.testing.assert_array_equal(finish, want.finish)
        np.testing.assert_array_equal(cend[crossed], want.chunk_end)
        np.testing.assert_array_equal(
            np.repeat(np.arange(len(s)), c)[crossed], want.chunk_flow)
        assert n_solves == want.n_solves
        if impl == "cuda":
            _assert_timings(tfs.transport(*args, quantum_frac=qf), want,
                            exact=True)


@pytest.mark.cuda
def test_cuda_one_launch_a_call():
    _needs_card()
    reset_launches()
    for src, dst, up, down, mp in MAXMIN_CASES:
        tfs.maxmin_rates(src, dst, up, down, mp)
    for src, dst, counts, cb, up, down, qf in TRANSPORT_CASES:
        tfs.transport(src, dst, counts, cb, up, down, quantum_frac=qf)
    assert LAUNCHES["fairshare_maxmin"] == len(MAXMIN_CASES)
    assert LAUNCHES["fairshare_transport"] == len(TRANSPORT_CASES)


@pytest.mark.cuda
def test_cuda_too_many_peers_raise():
    _needs_card()
    ext = kfs._build.extension()
    n = ext.fairshare_max_peers(torch.cuda.current_device()) + 1
    src, dst = np.array([0, 1]), np.array([1, 0])
    up = down = np.ones(n)
    with pytest.raises(ValueError, match="shared memory"):
        tfs.maxmin_rates(src, dst, up, down)
    with pytest.raises(ValueError, match="shared memory"):
        tfs.transport(src, dst, np.array([1, 1]), 1.0, up, down)


@pytest.mark.cuda
def test_cuda_watchdog_raises():
    _needs_card()
    src, dst, counts, up, down = _seeded(3, 20, 120)
    s, d, c, nbytes, u, w, quantum = tfs._flows(src, dst, counts, 1000.0,
                                                up, down, 0.0)
    assert tfs.transport_plain(src, dst, counts, 1000.0, up, down,
                               quantum_frac=0.0).n_solves > 2
    with pytest.raises(RuntimeError, match="watchdog"):
        kfs.fairshare_transport(s, d, c, nbytes, 1000.0, u, w, quantum,
                                device=torch.device("cuda"), max_segments=2)
