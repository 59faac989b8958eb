"""The port's checkpoint store against ``repro.checkpoint``, on the CPU.

``restore_or_init`` in both branches (no checkpoint: the init and round
0; a checkpoint of round r written by the JAX store: its leaves and
round r + 1, as the JAX function gives them), each dtype the port added
to its table (uint16, uint32, uint64 and the four float8 types) written
by one package and read by the other in both directions, exact in
bytes, and a dtype neither side knows raising ``ValueError`` by name.
Leaves are made from a numpy seed.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import load_checkpoint as jload  # noqa: E402
from repro.checkpoint import restore_or_init as jrestore  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.checkpoint import restore_or_init  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402

# numpy (ml_dtypes) and torch spellings of the added dtypes, with the
# signed integer type of the same width the bytes are compared through
NEW_DTYPES = [
    ("uint16", np.uint16, torch.uint16, np.int16),
    ("uint32", np.uint32, torch.uint32, np.int32),
    ("uint64", np.uint64, torch.uint64, np.int64),
    ("float8_e4m3fn", ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn, np.int8),
    ("float8_e5m2", ml_dtypes.float8_e5m2, torch.float8_e5m2, np.int8),
    ("float8_e4m3fnuz", ml_dtypes.float8_e4m3fnuz, torch.float8_e4m3fnuz,
     np.int8),
    ("float8_e5m2fnuz", ml_dtypes.float8_e5m2fnuz, torch.float8_e5m2fnuz,
     np.int8),
]


def _random_leaf(np_dt, shape, seed) -> np.ndarray:
    """Every bit pattern is fair: random bytes viewed as the dtype."""
    n = int(np.prod(shape)) * np.dtype(np_dt).itemsize
    raw = np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)
    return raw.view(np_dt).reshape(shape)


def _tensor_bytes(t: torch.Tensor, int_dt) -> bytes:
    view = {np.int8: torch.int8, np.int16: torch.int16,
            np.int32: torch.int32, np.int64: torch.int64}[int_dt]
    return t.contiguous().view(view).numpy().tobytes()


def _init():
    return ({"w": torch.zeros(4), "b": [torch.ones(2, 3)]}, {"arch": "t"})


def _jinit():
    return ({"w": jnp.zeros(4), "b": [jnp.ones((2, 3))]}, {"arch": "t"})


def test_restore_or_init_without_a_checkpoint_is_the_init(tmp_path):
    tree, meta, start = restore_or_init(str(tmp_path / "none"), _init)
    jtree, jmeta, jstart = jrestore(str(tmp_path / "none"), _jinit)
    assert (start, meta) == (jstart, jmeta) == (0, {"arch": "t"})
    np.testing.assert_array_equal(tree["w"].numpy(), np.asarray(jtree["w"]))
    np.testing.assert_array_equal(tree["b"][0].numpy(),
                                  np.asarray(jtree["b"][0]))


def test_restore_or_init_resumes_a_jax_checkpoint(tmp_path):
    rng = np.random.default_rng(5)
    w = rng.normal(size=4).astype(np.float32)
    b = rng.normal(size=(2, 3)).astype(np.float32)
    d = str(tmp_path)
    jsave(d, 3, {"w": jnp.asarray(w), "b": [jnp.asarray(b)]},
          meta={"arch": "t", "round": 3})
    jsave(d, 7, {"w": jnp.asarray(2 * w), "b": [jnp.asarray(-b)]},
          meta={"arch": "t", "round": 7})
    tree, meta, start = restore_or_init(d, _init)
    jtree, jmeta, jstart = jrestore(d, _jinit)
    assert start == jstart == 8
    assert meta == jmeta == {"arch": "t", "round": 7}
    assert tree["w"].dtype == torch.float32
    np.testing.assert_array_equal(tree["w"].numpy(), np.asarray(jtree["w"]))
    np.testing.assert_array_equal(tree["b"][0].numpy(),
                                  np.asarray(jtree["b"][0]))
    np.testing.assert_array_equal(tree["w"].numpy(), 2 * w)


def test_restore_or_init_resumes_its_own_checkpoint(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 0, {"w": torch.full((4,), 3.0),
                           "b": [torch.full((2, 3), -1.0)]},
                    meta={"arch": "t"})
    tree, meta, start = restore_or_init(d, _init)
    assert start == 1 and meta == {"arch": "t"}
    assert bool((tree["w"] == 3.0).all()) and bool((tree["b"][0] == -1).all())


@pytest.mark.parametrize("name,np_dt,t_dt,int_dt", NEW_DTYPES,
                         ids=[c[0] for c in NEW_DTYPES])
def test_new_dtype_from_the_jax_store_loads_exactly(tmp_path, name, np_dt,
                                                    t_dt, int_dt):
    leaf = _random_leaf(np_dt, (3, 5), seed=len(name))
    jsave(str(tmp_path), 1, {"x": leaf, "y": np.arange(3, dtype=np.int32)})
    like = {"x": torch.empty((3, 5), dtype=t_dt),
            "y": torch.empty(3, dtype=torch.int32)}
    tree, _ = load_checkpoint(str(tmp_path), 1, like)
    assert tree["x"].dtype == t_dt and tuple(tree["x"].shape) == (3, 5)
    assert _tensor_bytes(tree["x"], int_dt) == leaf.tobytes()
    assert tree["y"].tolist() == [0, 1, 2]


@pytest.mark.parametrize("name,np_dt,t_dt,int_dt", NEW_DTYPES,
                         ids=[c[0] for c in NEW_DTYPES])
def test_new_dtype_from_the_port_loads_exactly_in_jax(tmp_path, name, np_dt,
                                                      t_dt, int_dt):
    leaf = _random_leaf(np_dt, (4, 2), seed=len(name) + 1)
    t = torch.from_numpy(leaf.view(int_dt).copy()).view(t_dt)
    save_checkpoint(str(tmp_path), 2, {"x": t})
    tree, _ = jload(str(tmp_path), 2, {"x": np.zeros((4, 2), np_dt)})
    got = np.asarray(tree["x"])
    assert got.dtype == np.dtype(np_dt) and got.shape == (4, 2)
    assert got.tobytes() == leaf.tobytes()
    # and back into the port, unchanged
    save_checkpoint(str(tmp_path / "again"), 3, {"x": t})
    back, _ = load_checkpoint(str(tmp_path / "again"), 3,
                              {"x": torch.empty((4, 2), dtype=t_dt)})
    assert _tensor_bytes(back["x"], int_dt) == leaf.tobytes()


def test_unknown_dtype_raises_value_error_naming_it(tmp_path):
    with pytest.raises(ValueError, match="complex64"):
        save_checkpoint(str(tmp_path / "port"), 0,
                        {"x": torch.zeros(2, dtype=torch.complex64)})
    jsave(str(tmp_path / "jax"), 0, {"x": np.zeros(2, np.complex64)})
    with pytest.raises(ValueError, match="complex64"):
        load_checkpoint(str(tmp_path / "jax"), 0, {"x": torch.zeros(2)})
