"""The port's federated train step against ``repro.dist``, on the CPU.

This is the slice as a whole: the torrent aggregate, the pod-masked FL
step over three steps, AdamW and the schedules, the checkpoint format
and the train driver.  Both packages start from the same
JAX-initialised weights (``repro_torch.interop``) and see the same
numpy batches.  Tolerances: aggregates ``atol=1e-6`` (f32, the same
blocks and int8 codes on both sides); train-step losses, params and
optimizer state ``atol=2e-5`` after three AdamW steps (f32 gradients
agree to ~1e-7, and AdamW divides them by their own RMS); with int8
compression a few elements may differ by up to the learning rate (see
``_assert_trees_close``).
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import load_checkpoint as jload  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.dist import torrent as jtorrent  # noqa: E402
from repro.dist.fl_step import make_fl_train_step as jmake_step  # noqa: E402
from repro.models import ArchConfig as JArchConfig  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import torrent  # noqa: E402
from repro_torch.dist.fl_step import ElasticFLStep, make_fl_train_step  # noqa: E402
from repro_torch.launch.mesh import make_pod_mesh, pod_axis_size  # noqa: E402
from repro_torch.models import ArchConfig  # noqa: E402
from repro_torch.optim import OptState, adamw_init, adamw_update  # noqa: E402
from repro_torch.optim import schedules  # noqa: E402
from repro_torch.tree import flatten, leaves, tree_map  # noqa: E402

AGG_TOL = 1e-6
STEP_TOL = 2e-5
LR = 1e-2
CFG_KW = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
              n_kv=2, head_dim=8, d_ff=64, vocab=128, qk_norm=True,
              dtype="float32", remat=False)


def _updates(p=4, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "layer": {"w": rng.normal(size=(p, 16, 8)).astype(np.float32),
                  "b": rng.normal(size=(p, 24)).astype(np.float32)},
        "head": rng.normal(size=(p, 7, 3, 2)).astype(np.float32),
        "scale": rng.normal(size=(p,)).astype(np.float32),
        "tail": [rng.normal(size=(p, 5)).astype(np.float32)],
    }


def _both(tree):
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            tree_map(torch.from_numpy, tree))


def _assert_trees_close(t_tree, j_tree, atol, *, flip_atol=None):
    """Leafwise ``atol``.  With ``flip_atol``, at most 1% of the
    elements may instead differ by up to ``flip_atol``: an int8 code
    lands one step apart where a gradient sits within float error of a
    rounding boundary, and AdamW moves that element differently."""
    tl = leaves(interop.to_numpy(t_tree))
    jl = jax.tree_util.tree_leaves(j_tree)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        b = np.asarray(b, np.float32) if b.dtype == jnp.bfloat16 else \
            np.asarray(b)
        assert a.shape == b.shape
        if flip_atol is None:
            np.testing.assert_allclose(a, b, atol=atol, rtol=0)
        else:
            assert np.mean(~np.isclose(a, b, atol=atol, rtol=0)) <= 1e-2
            np.testing.assert_allclose(a, b, atol=flip_atol, rtol=0)


# ----------------------------------------------------------------------
# torrent aggregate
# ----------------------------------------------------------------------

@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("n_blocks", [1, 4, 7])
def test_torrent_fedavg_vs_jax(compress, n_blocks):
    j, t = _both(_updates())
    w = np.array([1., 2., 3., 4.], np.float32)
    a = np.array([1., 1., 0., 1.], np.float32)
    want = jtorrent.torrent_fedavg(j, jnp.asarray(w), jnp.asarray(a),
                                   n_blocks=n_blocks, compress=compress)
    got = torrent.torrent_fedavg(t, torch.from_numpy(w),
                                 torch.from_numpy(a), n_blocks=n_blocks,
                                 compress=compress)
    _assert_trees_close(got, want, AGG_TOL)


def test_torrent_fedavg_pytree_structure_and_dtypes():
    ups = tree_map(torch.from_numpy, _updates())
    ups["layer"]["b"] = ups["layer"]["b"].bfloat16()
    out = torrent.torrent_fedavg(ups, torch.ones(4), torch.ones(4),
                                 n_blocks=2)
    assert flatten(out)[1] == flatten(tree_map(lambda l: l[0], ups))[1]
    for i, o in zip(leaves(ups), leaves(out)):
        assert o.shape == i.shape[1:] and o.dtype == i.dtype


@pytest.mark.parametrize("compress", [False, True])
def test_torrent_zero_mass_and_masked_nan_pod(compress):
    j, t = _both(_updates())
    w = np.array([1., 2., 3., 4.], np.float32)
    for out in (torrent.torrent_fedavg(t, torch.from_numpy(w),
                                       torch.zeros(4), compress=compress),
                torrent.torrent_fedavg(t, torch.zeros(4), torch.ones(4),
                                       compress=compress)):
        for l in leaves(out):
            assert not torch.isnan(l).any()
            assert (l == 0).all()
    nan = tree_map(lambda l: l.clone(), t)
    for l in leaves(nan):
        l[2] = float("nan")
    a = np.array([1., 1., 0., 1.], np.float32)
    got = torrent.torrent_fedavg(nan, torch.from_numpy(w),
                                 torch.from_numpy(a), compress=compress)
    want = jtorrent.torrent_fedavg(j, jnp.asarray(w), jnp.asarray(a),
                                   compress=compress)
    for l in leaves(got):
        assert torch.isfinite(l).all()
    _assert_trees_close(got, want, AGG_TOL)


def test_take_pods_equals_masked_ring():
    """A P'-ring over the surviving pods == the P-ring with the departed
    pods masked, in both packages."""
    j, t = _both(_updates())
    w = np.array([3., 1., 2., 5.], np.float32)
    keep = [0, 1, 3]
    small = torrent.torrent_fedavg(torrent.take_pods(t, keep),
                                   torch.from_numpy(w[keep]),
                                   torch.ones(3))
    masked = torrent.torrent_fedavg(t, torch.from_numpy(w),
                                    torch.tensor([1., 1., 0., 1.]))
    for x, y in zip(leaves(small), leaves(masked)):
        torch.testing.assert_close(x, y, atol=AGG_TOL, rtol=0)
    want = jtorrent.torrent_fedavg(jtorrent.take_pods(j, keep),
                                   jnp.asarray(w[keep]), jnp.ones(3))
    _assert_trees_close(small, want, AGG_TOL)


@pytest.mark.parametrize("compress", [False, True])
def test_ring_emulation_vs_jax(compress):
    blocks = np.random.default_rng(1).normal(size=(5, 3, 16)).astype(
        np.float32)
    want = np.asarray(jtorrent.ring_allgather_emulated(
        jnp.asarray(blocks), compress=compress))
    got = torrent.ring_allgather_emulated(torch.from_numpy(blocks),
                                          compress=compress).numpy()
    assert got.shape == (5, 5, 3, 16)
    np.testing.assert_allclose(got, want, atol=AGG_TOL, rtol=0)
    for dest in range(5):
        np.testing.assert_array_equal(got[dest], got[0])


# ----------------------------------------------------------------------
# the FL train step, three steps against the JAX step
# ----------------------------------------------------------------------

def _step_setup(n_pods, b_local=4, t=16, seed=0, arch=None,
                dtype="float32"):
    """Both packages' configs (CFG_KW's, or ``arch``'s reduced one in
    ``dtype``), the same JAX-initialised params and optimizer state, and
    three numpy batches."""
    if arch is None:
        jcfg, tcfg = JArchConfig(**CFG_KW), ArchConfig(**CFG_KW)
    else:
        jcfg = jax_config(arch, reduced=True).replace(dtype=dtype)
        tcfg = get_config(arch, reduced=True).replace(dtype=dtype)
    jp = jinit(jcfg, jax.random.PRNGKey(seed))
    jo = jadamw_init(jp)
    np_p = jax.tree_util.tree_map(np.asarray, jp)
    tp = interop.params_from_numpy(np_p, "cpu")
    to = interop.opt_from_numpy(jax.tree_util.tree_map(np.asarray, jo),
                                "cpu")
    rng = np.random.default_rng(seed)
    v = jcfg.vocab
    batches = [{"inputs": rng.integers(0, v, size=(n_pods, b_local, t)),
                "labels": rng.integers(0, v, size=(n_pods, b_local, t))}
               for _ in range(3)]
    return jcfg, tcfg, (jp, jo), (tp, to), batches


def _assert_dtypes_match(t_tree, j_tree):
    tl = leaves(t_tree)
    jl = jax.tree_util.tree_leaves(j_tree)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)


@pytest.mark.parametrize("variant", ["pods1", "pods2", "pods4",
                                     "straggler", "microbatch",
                                     "compress", "granite",
                                     "granite_bf16"])
def test_fl_train_step_three_steps_vs_jax(variant):
    """``granite`` is reduced granite-moe-1b-a400m (moe layers) in f32
    with P = 2; ``granite_bf16`` the same in bf16, whose f32 router sits
    among bf16 leaves: every leaf of the params and of AdamW's master, m
    and v keeps JAX's dtype through the steps, and the losses agree to
    the bf16 tolerance (bf16 gradients differ in their last bits, which
    AdamW's sign-like first steps carry into the values, so the values
    are held in the f32 case)."""
    n_pods = {"pods1": 1, "pods2": 2, "granite": 2,
              "granite_bf16": 2}.get(variant, 4)
    kw = {"microbatch": {"microbatch": 2},
          "compress": {"compress": True}}.get(variant, {})
    w = np.array([1., 2., 3., 4.][:n_pods], np.float32)
    a = np.ones(n_pods, np.float32)
    if variant == "straggler":
        a[2] = 0.0
    arch = "granite-moe-1b-a400m" if variant.startswith("granite") else None
    dtype = "bfloat16" if variant == "granite_bf16" else "float32"
    jcfg, tcfg, (jp, jo), (tp, to), batches = _step_setup(n_pods, arch=arch,
                                                          dtype=dtype)
    jstep = jax.jit(jmake_step(jcfg, None,
                               lr_schedule=jsched.constant_lr(LR),
                               n_pods=n_pods, **kw))
    tstep = make_fl_train_step(tcfg, lr_schedule=schedules.constant_lr(LR),
                               n_pods=n_pods, **kw)
    loss_tol = 1e-2 if dtype == "bfloat16" else STEP_TOL
    for batch in batches:
        jp, jo, jm = jstep(jp, jo, jax.tree_util.tree_map(jnp.asarray,
                                                          batch),
                           jnp.asarray(w), jnp.asarray(a))
        tp, to, tm = tstep(tp, to, tree_map(torch.as_tensor, batch),
                           torch.from_numpy(w), torch.from_numpy(a))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=loss_tol, rtol=loss_tol)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-7)
    assert int(to.step) == int(jo.step) == 3
    for ours, theirs in ((tp, jp), (to.master, jo.master), (to.m, jo.m),
                         (to.v, jo.v)):
        _assert_dtypes_match(ours, theirs)
    if arch is not None:
        routers = [tp["cycles"]["slot0"]["router"],
                   to.master["cycles"]["slot0"]["router"]]
        assert all(r.dtype == torch.float32 for r in routers)
        want = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        assert tp["cycles"]["slot0"]["moe_gate"].dtype == want
        assert tp["embed"].dtype == want
    if dtype == "bfloat16":
        return
    # compression: a code one int8 step apart; granite: the few expert
    # weights whose gradient sits near AdamW's eps (|g| < 1e-7 for about
    # 5e-5 of them), where the f32 rounding of the gradient moves the
    # update
    flip = LR if variant in ("compress", "granite") else None
    for ours, theirs in ((tp, jp), (to.master, jo.master), (to.m, jo.m),
                         (to.v, jo.v)):
        _assert_trees_close(ours, theirs, STEP_TOL, flip_atol=flip)


def test_straggler_pod_cannot_influence_params():
    _, tcfg, _, (tp, to), batches = _step_setup(4)
    step = make_fl_train_step(tcfg, lr_schedule=schedules.constant_lr(1e-3),
                              n_pods=4)
    w, a = torch.ones(4), torch.tensor([1., 1., 1., 0.])
    batch = tree_map(torch.as_tensor, batches[0])
    clone = (lambda tree: tree_map(torch.clone, tree))
    p_ref, _, m = step(clone(tp), clone(to), batch, w, a)
    assert math.isfinite(float(m["loss"]))
    corrupted = dict(batch)
    corrupted["inputs"] = batch["inputs"].clone()
    corrupted["inputs"][3] = 0
    p_alt, _, _ = step(clone(tp), clone(to), corrupted, w, a)
    for x, y in zip(leaves(p_ref), leaves(p_alt)):
        assert torch.equal(x, y)


def test_zero_active_mass_round_is_a_noop():
    _, tcfg, _, (tp, to), batches = _step_setup(4)
    step = make_fl_train_step(tcfg, lr_schedule=schedules.constant_lr(1e-3),
                              n_pods=4)
    before = tree_map(torch.clone, (tp, to))
    p2, o2, _ = step(tp, to, tree_map(torch.as_tensor, batches[0]),
                     torch.ones(4), torch.zeros(4))
    for x, y in zip(leaves(before), leaves((p2, o2))):
        assert torch.equal(x, y)


def test_elastic_step_rebuilds_per_pod_count():
    _, tcfg, _, (tp, to), _ = _step_setup(4)
    step = ElasticFLStep(tcfg, lr_schedule=schedules.constant_lr(1e-3),
                         mesh_factory=lambda p: None)
    rng = np.random.default_rng(0)
    for p in (4, 3, 4):
        batch = {"inputs": torch.as_tensor(rng.integers(0, 128, (p, 2, 8))),
                 "labels": torch.as_tensor(rng.integers(0, 128, (p, 2, 8)))}
        tp, to, m = step(tp, to, batch, torch.ones(p), torch.ones(p))
        assert math.isfinite(float(m["loss"]))
    assert step.pod_counts == [3, 4]
    assert int(to.step) == 3


def test_reference_mesh_call_shapes():
    """The JAX package's mesh arguments, in its own call shapes
    (``repro/launch/train.py:116-141``): ``ElasticFLStep(cfg,
    lr_schedule=..., mesh_factory=mf)``, ``make_fl_train_step(cfg, mesh,
    lr_schedule=..., n_pods=..., rules=...)`` and ``torrent_fedavg(...,
    mesh=...)``.  ``None``, or a factory returning ``None``, runs the
    single-device path bit for bit; so does a mesh without a pod axis
    larger than 1 (``make_pod_mesh(1)`` in one process), and a pod axis
    whose size differs from the updates' leading axis raises
    ``ValueError``, as the reference does.  The multi-rank ring is held
    in ``tests/test_torch_dist_ranks.py``."""
    _, tcfg, _, (tp, to), batches = _step_setup(4)
    sched = schedules.linear_warmup_cosine(1e-2, 10, 20)
    batch = tree_map(torch.as_tensor, batches[0])
    w, a = torch.ones(4), torch.tensor([1., 1., 0., 1.])
    clone = (lambda tree: tree_map(torch.clone, tree))
    asked = []

    def mesh_factory(p: int):
        asked.append(p)
        return None

    want = make_fl_train_step(tcfg, None, lr_schedule=sched, n_pods=4)(
        clone(tp), clone(to), batch, w, a)
    step = ElasticFLStep(tcfg, lr_schedule=sched, mesh_factory=mesh_factory)
    got = step(clone(tp), clone(to), batch, w, a)
    direct = make_fl_train_step(tcfg, None, lr_schedule=sched, n_pods=4,
                                rules={"batch": "data"})(
        clone(tp), clone(to), batch, w, a)
    assert asked == [4] and step.pod_counts == [4]
    for out in (got, direct):
        for x, y in zip(leaves(out[:2]), leaves(want[:2])):
            assert torch.equal(x, y)
        assert float(out[2]["loss"]) == float(want[2]["loss"])
    with pytest.raises(TypeError, match="mesh_factory"):
        ElasticFLStep(tcfg, lr_schedule=sched)    # required, as in JAX
    mesh = make_pod_mesh(1)             # one rank: a pod axis of size 1
    assert mesh.is_member and pod_axis_size(mesh) == 1
    runs = [make_fl_train_step(tcfg, mesh, lr_schedule=sched, n_pods=4)(
                clone(tp), clone(to), batch, w, a),
            ElasticFLStep(tcfg, lr_schedule=sched,
                          mesh_factory=lambda p: mesh)(
                clone(tp), clone(to), batch, w, a)]
    for out in runs:
        for x, y in zip(leaves(out[:2]), leaves(want[:2])):
            assert torch.equal(x, y)
    ups = tree_map(torch.from_numpy, _updates())
    agg = torrent.torrent_fedavg(ups, w, a, mesh=None, n_blocks=4)
    for x, y in zip(leaves(agg),
                    leaves(torrent.torrent_fedavg(ups, w, a, n_blocks=4))):
        assert torch.equal(x, y)
    for x, y in zip(leaves(agg),
                    leaves(torrent.torrent_fedavg(ups, w, a, mesh=mesh))):
        assert torch.equal(x, y)

    class TwoPods:                      # what a 2-rank pod mesh reports
        axis_names = ("pod", "data", "model")
        devices = np.zeros((2, 1, 1))

    with pytest.raises(ValueError, match="pod axis size 2"):
        make_fl_train_step(tcfg, TwoPods(), lr_schedule=sched, n_pods=4)
    with pytest.raises(ValueError, match="pod axis size 2"):
        torrent.torrent_fedavg(ups, w, a, mesh=TwoPods())


# ----------------------------------------------------------------------
# AdamW, schedules, checkpoints
# ----------------------------------------------------------------------

def test_adamw_three_updates_vs_jax():
    rng = np.random.default_rng(7)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": [rng.normal(size=(4,)).astype(np.float32)]}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jo = jadamw_init(jp)
    tp = interop.params_from_numpy(params, "cpu")
    to = adamw_init(tp)
    for i in range(3):
        g = {"a": rng.normal(size=(5, 3)).astype(np.float32) * (i + 1),
             "b": [rng.normal(size=(4,)).astype(np.float32) * 3]}
        jp, jo = jadamw_update(jax.tree_util.tree_map(jnp.asarray, g), jo,
                               jp, lr=jnp.float32(3e-2))
        tp, to = adamw_update(tree_map(torch.from_numpy, g), to, tp,
                              lr=3e-2)
    assert int(to.step) == 3
    _assert_trees_close(tp, jp, 1e-6)
    _assert_trees_close((to.master, to.m, to.v), (jo.master, jo.m, jo.v),
                        1e-6)


def test_schedules_step_for_step_vs_jax():
    pairs = [(schedules.constant_lr(3e-3), jsched.constant_lr(3e-3)),
             (schedules.cosine_lr(1e-2, 25), jsched.cosine_lr(1e-2, 25)),
             (schedules.linear_warmup_cosine(3e-3, 10, 40),
              jsched.linear_warmup_cosine(3e-3, 10, 40))]
    for ours, theirs in pairs:
        for s in range(45):
            assert ours(torch.tensor(s, dtype=torch.int32)) == \
                pytest.approx(float(theirs(jnp.int32(s))), rel=1e-6,
                              abs=1e-12)
    assert schedules.linear_warmup_cosine(3e-3, 10, 40)(0) == 0.0


def test_jax_checkpoint_loads_in_the_port_and_back(tmp_path):
    jcfg = JArchConfig(**dict(CFG_KW, dtype="bfloat16"))
    tcfg = ArchConfig(**dict(CFG_KW, dtype="bfloat16"))
    jp = jinit(jcfg, jax.random.PRNGKey(3))
    jo = jadamw_init(jp)._replace(step=jnp.int32(7))
    jsave(str(tmp_path), 5, (jp, jo), meta={"pods": 2})
    from repro_torch.models import init_params
    like_p = init_params(tcfg, torch.Generator().manual_seed(0))
    like = (like_p, adamw_init(like_p))
    (tp, to), meta = load_checkpoint(str(tmp_path), 5, like)
    assert meta == {"pods": 2}
    assert isinstance(to, OptState) and int(to.step) == 7
    assert tp["embed"].dtype == torch.bfloat16
    _assert_trees_close((tp, to), (jp, jo), 0.0)
    # and the port's checkpoint loads in the JAX package
    save_checkpoint(str(tmp_path / "port"), 6, (tp, to), meta={"pods": 3})
    (jp2, jo2), meta2 = jload(str(tmp_path / "port"), 6, (jp, jo))
    assert meta2 == {"pods": 3}
    for x, y in zip(jax.tree_util.tree_leaves((jp, jo)),
                    jax.tree_util.tree_leaves((jp2, jo2))):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      np.asarray(y, np.float32))


# ----------------------------------------------------------------------
# the train driver
# ----------------------------------------------------------------------

def test_train_main_drop_pod_drill_on_cpu(capsys, tmp_path):
    from repro_torch.launch import train
    hist = []
    final = train.main(["--reduced", "--pods", "3", "--drop-pod", "1",
                        "--steps", "6", "--batch", "6", "--seq", "16",
                        "--device", "cpu", "--ckpt", str(tmp_path)],
                       history=hist)
    out = capsys.readouterr().out
    assert "re-meshing 3 -> 2 pods" in out
    assert "re-mesh continuity ok" in out
    assert math.isfinite(final)
    assert [h["pods"] for h in hist] == [3, 3, 3, 2, 2, 2]


def test_synthetic_batch_matches_jax_driver():
    from repro.launch.train import synthetic_batch as jbatch
    from repro_torch.launch.train import synthetic_batch
    for frames in (0, 8):
        jb = jbatch(np.random.default_rng(4), 2, 3, 10, 50, frames=frames)
        tb = synthetic_batch(np.random.default_rng(4), 2, 3, 10, 50,
                             frames=frames)
        for k in ("inputs", "labels"):
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
