"""The port's FL stack (``repro_torch.fl``) against the JAX package's
``repro.fl``, on the CPU.

JAX's ``jax.random`` initialisation cannot be reproduced in torch, so
every comparison starts the port from JAX's own initial weights, carried
over as numpy arrays (``params0``).  The models and one client's local
training are held at ``atol 1e-5``, the aggregations at ``1e-6``, the
Metropolis matrix exactly; the host side of a run (participation,
rejoin rounds, reconstruction, agreement) exactly, and each round's
test accuracy to one test sample (``1 / n_test``) in the rounds where
the port's own accuracy does not move by more under a one-ulp change
of one initial weight (``rounds_held``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.overlay import random_overlay
from repro.data.synthetic import make_synthetic
from repro.fl import baselines as jbase
from repro.fl import client as jclient
from repro.fl import models_small as jmodels
from repro.fl import runner as jrunner

from repro_torch.fl import baselines as tbase
from repro_torch.fl import client as tclient
from repro_torch.fl import models_small as tmodels
from repro_torch.fl import runner as trunner
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.tree import flatten

ATOL_MODEL = 1e-5
ATOL_AGG = 1e-6
CPU = torch.device("cpu")
SHAPES = {"synth-mnist": (28, 28, 1), "synth-cifar": (32, 32, 3)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several processes at once; torch's default of a
    thread a core in each would oversubscribe the CPU many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_init(model, shape, seed=0, classes=10):
    return _np(jmodels.MODELS[model][0](jax.random.PRNGKey(seed), shape,
                                        classes))


def _assert_tree_close(jtree, ttree, atol, what):
    jl, jtd = jax.tree_util.tree_flatten(jtree)
    tl, _ = flatten(to_numpy(ttree))
    assert len(jl) == len(tl), what
    for i, (a, b) in enumerate(zip(jl, tl)):
        a = np.asarray(a)
        assert a.shape == b.shape and b.dtype == np.float32, (what, i)
        np.testing.assert_allclose(b, a, rtol=0, atol=atol,
                                   err_msg=f"{what} leaf {i}")


def _cfgs(**kw):
    """The same FL configuration for both packages."""
    local = kw.pop("local", {})
    return (jrunner.FLConfig(local=jclient.LocalSpec(**local), **kw),
            trunner.FLConfig(local=tclient.LocalSpec(**local), **kw))


def _params0(jcfg):
    train, _ = make_synthetic(jcfg.dataset, jcfg.n_train, jcfg.n_test,
                              seed=jcfg.seed)
    return _jax_init(jcfg.model, train.x.shape[1:], jcfg.seed,
                     train.num_classes)


# -- models --------------------------------------------------------------

@pytest.mark.parametrize("model", ["mlp", "cnn"])
@pytest.mark.parametrize("dataset", ["synth-mnist", "synth-cifar"])
def test_model_apply_matches_jax(model, dataset):
    shape = SHAPES[dataset]
    params = _jax_init(model, shape, seed=1)
    x = np.random.default_rng(0).uniform(0, 1, (37, *shape)).astype(
        np.float32)
    want = np.asarray(jmodels.MODELS[model][1](params, jnp.asarray(x)))
    got = tmodels.MODELS[model][1](params_from_numpy(params, CPU),
                                   torch.from_numpy(x))
    assert got.shape == want.shape == (37, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_MODEL)


@pytest.mark.parametrize("size", [28, 27, 16, 15, 8, 7])
@pytest.mark.parametrize("stride", [1, 2])
def test_same_padding_matches_xla(size, stride):
    """The explicit pad reproduces XLA's "SAME" (asymmetric at stride 2:
    the extra row and column go to the high side)."""
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size + 1, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 5)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    hl, hh = tmodels._same_pad(size, stride)
    wl, wh = tmodels._same_pad(size + 1, stride)
    got = torch.nn.functional.conv2d(
        torch.nn.functional.pad(xt, (wl, wh, hl, hh)),
        torch.from_numpy(w).permute(3, 2, 0, 1), stride=stride)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_MODEL)


def test_cross_entropy_and_accuracy_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((50, 10)).astype(np.float32) * 3
    labels = rng.integers(0, 10, 50).astype(np.int32)
    want = float(jmodels.cross_entropy(jnp.asarray(logits),
                                       jnp.asarray(labels)))
    got = float(tmodels.cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=1e-6)
    params = _jax_init("mlp", (28, 28, 1), seed=2)
    x = rng.uniform(0, 1, (1100, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, 1100).astype(np.int32)
    assert tmodels.accuracy(tmodels.mlp_apply, params_from_numpy(params, CPU),
                            x, y) == jmodels.accuracy(jmodels.mlp_apply,
                                                      params, x, y)


@pytest.mark.parametrize("model,shape", [
    ("mlp", (28, 28, 1)), ("mlp", (32, 32, 3)), ("cnn", (28, 28, 1)),
    ("cnn", (32, 32, 3))])
def test_init_law(model, shape):
    """Shapes and dtypes of the reference's tree, zero biases, normal
    weights of std sqrt(2 / fan_in) (within 5% on the wide layers), the
    same weights again from the same seed."""
    init = tmodels.MODELS[model][0]
    params = init(torch.Generator().manual_seed(0), shape, 10)
    ref = _jax_init(model, shape)
    assert jax.tree_util.tree_structure(ref) == \
        jax.tree_util.tree_structure(to_numpy(params))
    for name, layer in params.items():
        assert layer["w"].shape == ref[name]["w"].shape, name
        assert layer["w"].dtype == layer["b"].dtype == torch.float32
        assert layer["w"].device == CPU
        assert not layer["b"].any(), name
        w = layer["w"]
        fan_in = int(np.prod(w.shape[:-1]))
        if w.numel() >= 10_000:
            assert float(w.std()) == pytest.approx(np.sqrt(2 / fan_in),
                                                   rel=0.05), name
            assert abs(float(w.mean())) < 0.05 * np.sqrt(2 / fan_in), name
    again = init(torch.Generator().manual_seed(0), shape, 10)
    other = init(torch.Generator().manual_seed(1), shape, 10)
    for a, b, c in zip(flatten(params)[0], flatten(again)[0],
                       flatten(other)[0]):
        assert torch.equal(a, b)
        assert a.abs().sum() == 0 or not torch.equal(a, c)


# -- one client's local training -----------------------------------------

@pytest.mark.parametrize("model,dataset,n", [
    ("mlp", "synth-cifar", 215), ("mlp", "synth-mnist", 33),
    ("cnn", "synth-mnist", 215), ("cnn", "synth-cifar", 65)])
def test_local_train_matches_jax(model, dataset, n):
    """Momentum SGD over the same numpy batches (a last batch of one
    sample, at n 33 and 65, is skipped), two epochs."""
    train, _ = make_synthetic(dataset, n, 10, seed=0)
    params = _jax_init(model, SHAPES[dataset], seed=3)
    spec = dict(epochs=2, batch_size=32, lr=0.03, momentum=0.9)
    jtrain = jclient.make_local_train(jmodels.MODELS[model][1],
                                      jclient.LocalSpec(**spec))
    ttrain = tclient.make_local_train(tmodels.MODELS[model][1],
                                      tclient.LocalSpec(**spec))
    jrng, trng = np.random.default_rng(5), np.random.default_rng(5)
    want = jtrain(params, train.x, train.y, jrng)
    got = ttrain(params_from_numpy(params, CPU), train.x, train.y, trng)
    _assert_tree_close(want, got, ATOL_MODEL, "local_train")
    # The same draws were taken from the batching stream.
    assert jrng.integers(1 << 30) == trng.integers(1 << 30)
    # The update and its application are the reference's.
    upd = tclient.compute_update(params_from_numpy(params, CPU), got)
    _assert_tree_close(jclient.compute_update(params, want), upd,
                       ATOL_MODEL, "compute_update")
    back = tclient.apply_aggregate(params_from_numpy(params, CPU), upd)
    _assert_tree_close(want, back, ATOL_MODEL, "apply_aggregate")


# -- baselines -------------------------------------------------------------

def _updates(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"fc": {"w": rng.standard_normal((7, 5)).astype(np.float32),
                    "b": rng.standard_normal(5).astype(np.float32)},
             "conv": {"w": rng.standard_normal((3, 3, 2, 4)).astype(
                 np.float32)}} for _ in range(n)]


@pytest.mark.parametrize("n,seed", [(6, 0), (10, 1), (16, 2)])
def test_fedavg_server_and_gossip_mix_match_jax(n, seed):
    ups = _updates(n, seed)
    tups = [params_from_numpy(u, CPU) for u in ups]
    weights = np.random.default_rng(seed).integers(1, 400, n).astype(
        np.float64)
    _assert_tree_close(jbase.fedavg_server(ups, weights),
                       tbase.fedavg_server(tups, weights), ATOL_AGG,
                       "fedavg_server")
    adj = random_overlay(n, min(4, n - 1),
                         rng=np.random.default_rng((seed, 1)))
    w = jbase.metropolis_weights(adj)
    tw = tbase.metropolis_weights(adj)
    assert w.dtype == tw.dtype and w.tobytes() == tw.tobytes()
    np.testing.assert_allclose(tw.sum(0), 1.0, atol=1e-12)
    np.testing.assert_allclose(tw.sum(1), 1.0, atol=1e-12)
    jm, tm = jbase.gossip_mix(ups, w), tbase.gossip_mix(tups, w)
    assert len(jm) == len(tm) == n
    for i, (a, b) in enumerate(zip(jm, tm)):
        _assert_tree_close(a, b, ATOL_AGG, f"gossip_mix client {i}")


def test_gossip_eval_matches_jax():
    shape = (28, 28, 1)
    clients = [_jax_init("mlp", shape, seed=s) for s in range(4)]
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (300, *shape)).astype(np.float32)
    y = rng.integers(0, 10, 300).astype(np.int32)
    want = jbase.gossip_eval(jmodels.mlp_apply, clients, x, y)
    got = tbase.gossip_eval(tmodels.mlp_apply,
                            [params_from_numpy(c, CPU) for c in clients],
                            x, y)
    assert got == want


# -- whole runs --------------------------------------------------------------

RUN = dict(dataset="synth-cifar", dist="dir0.1", n_clients=8, rounds=3,
           local=dict(epochs=1, batch_size=32, lr=0.03), n_train=1200,
           n_test=500, seed=0, min_degree=4)


def ulp_bumped(params0):
    """``params0`` with every weight one ulp larger (the biases, zero,
    kept)."""
    return jax.tree_util.tree_map(
        lambda a: np.where(a != 0, np.nextafter(a, np.float32(np.inf)), a),
        params0)


def rounds_held(run, params0, n_test) -> int:
    """The rounds before the first in which a one-ulp change of the
    initial weights moves the port's own accuracy by more than one test
    sample.  Two f32 runs that sum in another order (JAX's and the
    port's) part where a ReLU pre-activation sits within an ulp of 0,
    and a trajectory can then drift; from that round on, comparing them
    cannot tell a fault from it, so the accuracy is held before it (the
    steps themselves are held by the model, local-training and
    aggregation tests)."""
    a = run(params0).accuracy
    b = run(ulp_bumped(params0)).accuracy
    held = next((r for r, (x, y) in enumerate(zip(a, b))
                 if abs(x - y) > 1.0 / n_test + 1e-12), len(a))
    assert held >= 1, "a one-ulp change moves round 1's accuracy"
    return held


def _assert_runs_agree(j, t, n_test, held):
    assert type(t).__name__ == type(j).__name__
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if f.name == "accuracy":
            assert len(a) == len(b)
            np.testing.assert_allclose(b[:held], a[:held], rtol=0,
                                       atol=1.0 / n_test + 1e-12)
        else:
            assert a == b, f"{f.name}: {a!r} != {b!r}"


def _run_both(method, jcfg, tcfg):
    """JAX's run, the port's from JAX's weights, and the rounds held."""
    want = jrunner.run_experiment(method, jcfg)
    p0 = _params0(jcfg)

    def run(p):
        return trunner.run_experiment(method, tcfg, device="cpu",
                                      params0=p)
    return want, run(p0), rounds_held(run, p0, jcfg.n_test)


@pytest.mark.parametrize("model", ["mlp", "cnn"])
@pytest.mark.parametrize("method", ["cfl", "gossip", "fltorrent"])
def test_run_experiment_matches_jax(method, model):
    jcfg, tcfg = _cfgs(**dict(RUN, model=model))
    want, got, held = _run_both(method, jcfg, tcfg)
    _assert_runs_agree(want, got, jcfg.n_test, held)


CHURN_RUNS = {
    # tests/test_session.py::test_rejoining_client_receives_current_round_params
    "rejoin": dict(dataset="synth-cifar", model="mlp", dist="dir0.5",
                   n_clients=8, rounds=6,
                   local=dict(epochs=1, batch_size=32, lr=0.03),
                   n_train=1500, n_test=400, seed=0, min_degree=4,
                   churn_rate=0.3, rejoin_after=1),
    # tests/test_session.py::test_runner_zero_churn_unchanged
    "zero": dict(dataset="synth-cifar", model="mlp", dist="dir0.5",
                 n_clients=6, rounds=3,
                 local=dict(epochs=1, batch_size=32, lr=0.03),
                 n_train=1000, n_test=300, seed=1, min_degree=3),
    "churn_aware_geometric": dict(
        dataset="synth-mnist", model="mlp", dist="iid", n_clients=8,
        rounds=4, local=dict(epochs=1, batch_size=32, lr=0.05),
        n_train=800, n_test=200, seed=2, min_degree=3, churn_rate=0.3,
        rejoin_after=2, rejoin_dist="geometric",
        spray_budget="churn_aware"),
}


@pytest.mark.parametrize("name", sorted(CHURN_RUNS))
def test_churn_runs_match_jax(name):
    jcfg, tcfg = _cfgs(**CHURN_RUNS[name])
    want, got, held = _run_both("fltorrent", jcfg, tcfg)
    _assert_runs_agree(want, got, jcfg.n_test, held)
    if name == "rejoin":
        assert got.rejoin_rounds and got.stale_seen and got.caught_up
        assert got.agreement and any(p < 1.0 for p in got.participation)
    if name == "zero":
        assert got.participation == [1.0] * 3 and got.rejoin_rounds == []
        assert not got.stale_seen and got.caught_up and got.agreement


def test_fltorrent_trajectory_is_cfl_in_the_port():
    """The paper's aggregation claim on the port's own init: with every
    update reconstructable, FLTorrent's trajectory is CFL's."""
    _, tcfg = _cfgs(**dict(RUN, rounds=4))
    cfl = trunner.run_experiment("cfl", tcfg, device="cpu")
    flt = trunner.run_experiment("fltorrent", tcfg, device="cpu")
    assert flt.agreement and flt.reconstruct_frac == 1.0
    np.testing.assert_allclose(flt.accuracy, cfl.accuracy, atol=1e-3)
    assert flt.accuracy[-1] > flt.accuracy[0]


def test_run_experiment_rejects_unknown_method_and_spray_budget():
    _, tcfg = _cfgs(**dict(RUN, rounds=1, n_train=200, n_test=50))
    with pytest.raises(ValueError, match="fedprox"):
        trunner.run_experiment("fedprox", tcfg, device="cpu")
    with pytest.raises(ValueError, match="spray_budget"):
        trunner.run_experiment(
            "fltorrent", dataclasses.replace(tcfg, spray_budget="half"),
            device="cpu")


def test_run_experiment_needs_a_device_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    _, tcfg = _cfgs(**dict(RUN, rounds=1, n_train=200, n_test=50))
    for method in ("cfl", "gossip", "fltorrent"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trunner.run_experiment(method, tcfg)
