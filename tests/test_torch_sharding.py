"""The port's sharding rules (``repro_torch.sharding.api``) against the
JAX package's, on the CPU.

``param_specs`` must give, leaf by leaf, the JAX package's
PartitionSpec entries for every configuration at full size on the
production meshes and a small one.  Parameter shapes come from
``jax.eval_shape`` on the JAX side and the ``meta`` device on the
port's, so no weight is allocated.  Both spec functions read only a
mesh's ``axis_names`` and ``devices.shape``, so one stand-in mesh
object serves both packages.
"""
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.sharding import api as japi  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.sharding import api  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402


class StandInMesh:
    """What both packages' spec functions read of a mesh."""

    def __init__(self, shape, axis_names):
        self.axis_names = tuple(axis_names)
        self.devices = np.empty(shape)


MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "4x2x2": ((4, 2, 2), ("pod", "data", "model")),
}
_SHAPES: dict = {}


def _shapes(arch):
    """(JAX leaves with paths, the port's leaves with paths), cached."""
    if arch not in _SHAPES:
        jp = jax.eval_shape(lambda: jinit(jget_config(arch),
                                          jax.random.PRNGKey(0)))
        tp = init_params(get_config(arch), torch.Generator(), device="meta")
        _SHAPES[arch] = (jp, tp)
    return _SHAPES[arch]


def _jax_specs(jp, mesh):
    out = {}
    specs = japi.param_specs(jp, mesh)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for path, spec in flat:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        out[".".join(str(k) for k in keys)] = tuple(spec)
    return out


def _axes_of(spec):
    out = []
    for e in spec:
        if e is None:
            continue
        out.extend(e if isinstance(e, tuple) else (e,))
    return out


def test_same_archs():
    assert tuple(ARCHS) == tuple(JARCHS)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_equal_jax(arch, mesh_name):
    mesh = StandInMesh(*MESHES[mesh_name])
    jp, tp = _shapes(arch)
    want = _jax_specs(jp, mesh)
    paths, leaves, _ = flatten_with_paths(tp)
    got_tree = api.param_specs(tp, mesh)
    got = {}
    for keys, leaf in zip(paths, leaves):
        node = got_tree
        for k in keys:
            node = node[k]
        got[".".join(str(k) for k in keys)] = node
    assert set(got) == set(want)
    jshapes = {".".join(str(getattr(k, "key", getattr(k, "idx", None)))
                        for k in path): tuple(l.shape)
               for path, l in jax.tree_util.tree_flatten_with_path(jp)[0]}
    for keys, leaf in zip(paths, leaves):
        path = ".".join(str(k) for k in keys)
        assert tuple(leaf.shape) == jshapes[path], path
        assert leaf.device.type == "meta"
        spec = got[path]
        assert isinstance(spec, tuple) and len(spec) == leaf.dim(), path
        assert spec == want[path], (path, spec, want[path])
        axes = _axes_of(spec)
        assert len(axes) == len(set(axes)), f"dup axes in {path}: {spec}"


def test_divisibility_filter():
    mesh = StandInMesh((4, 16), ("data", "model"))
    # vocab 49155 (granite) is not divisible by 16 -> unsharded
    s = api.spec_for_path("embed", (49155, 1024), mesh, api.DEFAULT_RULES,
                          stacked=False)
    assert s == (None, "data")          # ZeRO falls to d_model (1024 % 4)
    assert s == tuple(japi.spec_for_path(
        "embed", (49155, 1024), mesh, japi.DEFAULT_RULES, stacked=False))
    s2 = api.spec_for_path("embed", (256000, 2304), mesh,
                           api.DEFAULT_RULES, stacked=False)
    assert s2[0] == "model"
    assert get_config("granite-moe-1b-a400m").vocab == 49155


def test_stacked_params_skip_leading_dim():
    mesh = StandInMesh((4, 16), ("data", "model"))
    s = api.spec_for_path("cycles.slot0.w_up", (13, 2304, 9216), mesh,
                          api.DEFAULT_RULES, stacked=True)
    assert s == (None, "data", "model")


def test_moe_expert_sharding():
    mesh = StandInMesh((4, 16), ("data", "model"))
    s = api.spec_for_path("cycles.slot0.moe_gate", (16, 64, 2048, 1024),
                          mesh, api.DEFAULT_RULES, stacked=True)
    assert s[1] == "model"              # expert axis -> EP over model
    assert "model" not in _axes_of(s[2:])   # no double use
    assert s == tuple(japi.spec_for_path(
        "cycles.slot0.moe_gate", (16, 64, 2048, 1024), mesh,
        japi.DEFAULT_RULES, stacked=True))
    # olmoe's 64 experts on a model axis of 128 stay whole
    s = api.spec_for_path("cycles.slot0.moe_up", (16, 64, 2048, 1024),
                          StandInMesh((1, 128), ("data", "model")),
                          api.DEFAULT_RULES, stacked=True)
    assert s[1] is None


def test_small_params_skip_zero():
    mesh = StandInMesh((4, 16), ("data", "model"))
    assert api.spec_for_path("final_norm", (2048,), mesh,
                             api.DEFAULT_RULES, stacked=False) == (None,)
    big = api.ZERO_MIN_ELEMS
    assert api.spec_for_path("cycles.slot0.ln1", (1, big), mesh,
                             api.DEFAULT_RULES, stacked=True) == (None, "data")
    assert api.spec_for_path("cycles.slot0.ln1", (1, big), mesh,
                             api.DEFAULT_RULES, stacked=True,
                             zero=False) == (None, None)


def test_logical_constraint_is_identity():
    x = torch.ones(4, 4)
    assert api.logical_constraint(x, "batch", None) is x
    with api.axis_rules(api.DEFAULT_RULES, StandInMesh((2, 2),
                                                       ("data", "model"))):
        assert api.logical_constraint(x, "batch", None) is x


def test_axis_rules_nest_per_thread():
    mesh = StandInMesh((2, 2), ("data", "model"))
    assert api.current_rules() is None
    seen = []
    with api.axis_rules({"batch": "data"}, mesh):
        with api.axis_rules(api.DEFAULT_RULES):
            assert api.current_rules()[1] is None
            t = threading.Thread(target=lambda: seen.append(
                api.current_rules()))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        rules, m = api.current_rules()
        assert rules == {"batch": "data"} and m is mesh
    assert api.current_rules() is None
    assert seen == [None]


def test_checkpoint_recomputation_keeps_the_binding():
    """``layers.checkpointed``: the recomputation, run by a backward on
    a thread without the binding (as autograd runs the backward of CUDA
    tensors), sees the forward's ``axis_rules``; a plain checkpoint's
    does not."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models.layers import checkpointed
    mesh = StandInMesh((2, 2), ("data", "model"))

    def meshes_seen(ckpt):
        seen = []

        def fn(x):
            state = api.current_rules()
            seen.append(None if state is None else state[1])
            return x.sin()

        x = torch.ones(3, requires_grad=True)
        with api.axis_rules(api.DEFAULT_RULES, mesh):
            y = ckpt(fn, x).sum()
        t = threading.Thread(target=y.backward)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive() and x.grad is not None
        return seen

    assert meshes_seen(checkpointed) == [mesh, mesh]
    assert meshes_seen(lambda f, x: checkpoint(f, x, use_reentrant=False)
                       ) == [mesh, None]
