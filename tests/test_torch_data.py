"""The port's ``repro_torch.data`` against the JAX package's ``data``.

Both are numpy code with the same rng streams, so datasets, client
partitions and token batches are held byte for byte."""
import numpy as np
import pytest

from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro.data import tokens as jtok

from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.data import tokens as ttok


def _same_bytes(a: np.ndarray, b: np.ndarray, what: str) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("name,n_train,n_test,seed", [
    ("synth-mnist", 300, 100, 0), ("synth-mnist", 257, 31, 3),
    ("synth-cifar", 300, 100, 0), ("synth-cifar", 129, 17, 7)])
def test_synthetic_datasets_byte_identical(name, n_train, n_test, seed):
    jtr, jte = jsyn.make_synthetic(name, n_train, n_test, seed=seed)
    ttr, tte = tsyn.make_synthetic(name, n_train, n_test, seed=seed)
    for j, t, split in ((jtr, ttr, "train"), (jte, tte, "test")):
        _same_bytes(j.x, t.x, f"{name} {split} x")
        _same_bytes(j.y, t.y, f"{name} {split} y")
        assert j.num_classes == t.num_classes and len(j) == len(t)


def test_unknown_dataset_raises():
    with pytest.raises(ValueError, match="synth-imagenet"):
        tsyn.make_synthetic("synth-imagenet", 10, 10)


@pytest.mark.parametrize("dist,n_clients,seed", [
    ("iid", 8, 0), ("iid", 7, 5), ("dir0.1", 10, 0), ("dir0.1", 16, 3),
    ("dir0.5", 8, 1), ("dir1.0", 20, 2)])
def test_partitions_byte_identical(dist, n_clients, seed):
    ds, _ = jsyn.make_synthetic("synth-mnist", 1500, 10, seed=seed)
    tds, _ = tsyn.make_synthetic("synth-mnist", 1500, 10, seed=seed)
    jp = jpart.partition(ds, n_clients, dist, seed=seed)
    tp = tpart.partition(tds, n_clients, dist, seed=seed)
    assert len(jp) == len(tp) == n_clients
    for v, (a, b) in enumerate(zip(jp, tp)):
        _same_bytes(a, b, f"{dist} client {v}")
    # Every sample lands with exactly one client.
    np.testing.assert_array_equal(np.sort(np.concatenate(tp)),
                                  np.arange(len(tds)))


def test_partition_errors_match_reference():
    ds, _ = tsyn.make_synthetic("synth-mnist", 40, 10, seed=0)
    with pytest.raises(ValueError):
        tpart.partition(ds, 4, "zipf", seed=0)
    # More clients than a Dirichlet draw can give two samples each.
    with pytest.raises(RuntimeError, match="min_size"):
        tpart.dirichlet_partition(ds, 30, 0.01, np.random.default_rng(0))


@pytest.mark.parametrize("vocab,batch,seq,seed,shard", [
    (1000, 4, 16, 0, (0, 1)), (256, 8, 33, 5, (1, 2)),
    (70_000, 6, 8, 2, (2, 3))])
def test_token_stream_batches_byte_identical(vocab, batch, seq, seed,
                                             shard):
    js = jtok.TokenStream(vocab, batch, seq, seed=seed, shard=shard)
    ts = ttok.TokenStream(vocab, batch, seq, seed=seed, shard=shard)
    for step in range(3):
        jb, tb = next(js), next(ts)
        assert jb.keys() == tb.keys()
        for k in jb:
            _same_bytes(jb[k], tb[k], f"step {step} {k}")
    assert (tb["tokens"] < min(vocab, 50_000)).all()


def test_token_batches_generator_byte_identical():
    jb = list(jtok.batches(512, 4, 12, steps=4, seed=9))
    tb = list(ttok.batches(512, 4, 12, steps=4, seed=9))
    assert len(jb) == len(tb) == 4
    for a, b in zip(jb, tb):
        for k in a:
            _same_bytes(a[k], b[k], k)
