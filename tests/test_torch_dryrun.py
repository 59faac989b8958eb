"""The port's dry run (``repro_torch.launch.{flops,specs,dryrun}``) and
its placed training step, against the JAX package, on the CPU.

- ``model_flops`` equal to JAX's for every configuration and shape;
- the cells' placement specs (parameters after serving's ZeRO switch,
  optimizer state, batch, decode caches) equal to JAX's ``build_cell``
  for every non-skipped cell on the four stand-in meshes of
  ``tests/test_torch_sharding.py``;
- the CLI: it refuses to claim a GPU that is not there, records a skip,
  and exits 1 on a failing cell;
- the placed FL step on spawned gloo ranks (``_spawn`` of
  ``tests/test_torch_dist_ranks.py``): reduced qwen3-1.7b,
  recurrentgemma-2b and olmoe-1b-7b in f32 on a 2 x 2 ``data`` x
  ``model`` grid, DTensor parameters placed by ``param_specs`` (the ZeRO
  threshold lowered so reduced weights split over ``data`` too), against
  the replicated step on the same grid and JAX's ``train_loss`` on the
  same weights; each rank's parameter bytes as the placements divide
  them; and the 8-rank ``pod`` x ``data`` x ``model`` step against the
  single-process ``n_pods = 2`` step.

The steps take lr 1e-4.  Adam's first step moves every weight by about
lr whatever the size of its gradient, so a gradient within f32
rounding of zero, summed in another order by the placed step, may move
its weight anywhere in [-lr, lr]: at lr 1e-3 one weight of reduced
qwen3-1.7b's 143,904 moves 2.5e-5 from the replicated step's while the
gradients agree to 1e-6 of their largest.  The moments m and v, which
hold the gradients, are compared at the same tolerance.
"""
import functools
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import test_torch_dist_ranks as ranks  # noqa: E402
from test_torch_sharding import MESHES, StandInMesh  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.launch import flops as jflops  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch.configs import (ARCHS, SHAPES, all_cells,  # noqa: E402
                                 get_config)
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.flops import model_flops  # noqa: E402
from repro_torch.sharding.api import _spec_leaves  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, s) for a, s, skip in all_cells() if skip is None]
PLACED_TOL = 2e-5
MOE_TOL = 1e-4
PLACED_ARCHS = ("qwen3-1.7b", "recurrentgemma-2b", "olmoe-1b-7b")
LR = 1e-4
# placed serving: reduced qwen3-1.7b as it is (kv heads split over
# model) and with one kv head (the decode cache split on head_dim, the
# prefill's query heads split and the kv head sliced to them)
SERVE_CFGS = (("qwen3-1.7b", {}), ("qwen3-1.7b-kv1", {"n_kv": 1}))
N_NEW = 3
FIDELITY_SHAPE = ("t", 32, 4, "train")


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_flops_equal_jax(arch, shape):
    want = jflops.model_flops(jget_config(arch), JSHAPES[shape])
    got = model_flops(get_config(arch), SHAPES[shape])
    assert got == pytest.approx(want, rel=1e-12)
    assert got > 0


# ----------------------------------------------------------------------
# placement specs against JAX's build_cell
# ----------------------------------------------------------------------

class _MemoJax:
    """``jax`` with ``eval_shape`` memoized, for JAX's ``build_cell``:
    it traces the same initialisers for a configuration on every mesh,
    and shapes do not depend on the mesh."""

    def __init__(self):
        self._memo: dict = {}

    def __getattr__(self, name):
        return getattr(jax, name)

    def eval_shape(self, fn, *args):
        if isinstance(fn, functools.partial):
            key = (fn.func, fn.args)
        elif fn.__closure__:
            key = (fn.__code__, tuple(c.cell_contents for c in fn.__closure__))
        else:
            key = (fn, tuple(id(a) for a in args))
        if key not in self._memo:
            self._memo[key] = (jax.eval_shape(fn, *args), args)
        return self._memo[key][0]


_JAX = _MemoJax()


def _as_tuple(spec):
    """A PartitionSpec as the port writes it: one entry a dim."""
    return tuple(spec)


def _jax_leaves(tree):
    from jax.sharding import PartitionSpec
    return [_as_tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_specs_equal_jax(arch, shape, mesh_name, monkeypatch):
    mesh = StandInMesh(*MESHES[mesh_name])
    monkeypatch.setattr(jspecs, "jax", _JAX)
    want = jspecs.build_cell(jget_config(arch), JSHAPES[shape], mesh)
    got = specs.cell_specs(get_config(arch), SHAPES[shape], mesh)
    w_in, g_in = want["in_specs"], got["in_specs"]
    # parameters (decode: after serving's ZeRO switch)
    assert _spec_leaves(g_in[0]) == _jax_leaves(w_in[0])
    kind = SHAPES[shape].kind
    if kind == "train":
        # optimizer state: step replicated, master/m/v as the params
        assert _spec_leaves(g_in[1]) == [()] + 3 * _jax_leaves(w_in[0])
        assert _jax_leaves(w_in[1]) == [()] + 3 * _jax_leaves(w_in[0])
        for k in ("inputs", "labels"):
            assert g_in[2][k] == _as_tuple(w_in[2][k]), k
        assert g_in[3:] == ((), ())
    elif kind == "prefill":
        assert g_in[1] == _as_tuple(w_in[1])
    else:
        assert _spec_leaves(g_in[1]) == _jax_leaves(w_in[1])   # caches
        assert g_in[2] == _as_tuple(w_in[2])
        zero_off = specs.decode_rules(get_config(arch), mesh,
                                      {"zero": "data"})["zero"] is None
        tp = dict(zip(mesh.axis_names, mesh.devices.shape)).get("model", 1)
        assert zero_off == (jget_config(arch).param_count() * 2 / tp
                            <= 512 * 2 ** 20)


def test_decode_zero_switch_keeps_chameleon_sharded():
    """chameleon-34b's TP-only replica is over 512 MiB a device on the
    16 x 16 mesh: its serving weights stay ZeRO-split; qwen3-1.7b's
    are not."""
    mesh = StandInMesh(*MESHES["16x16"])
    rules = {"zero": "data"}
    assert specs.decode_rules(get_config("chameleon-34b"), mesh,
                              rules)["zero"] == "data"
    assert specs.decode_rules(get_config("qwen3-1.7b"), mesh,
                              rules)["zero"] is None


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------

def _cli(tmp_path, *argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
         "--out", str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300)


def test_cli_refuses_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.run_cell("qwen3-1.7b", "decode_32k", False)


def test_cli_records_a_skip_and_a_failing_cell(tmp_path):
    import json
    ok = _cli(tmp_path, "--arch", "qwen3-1.7b", "--shape", "long_500k",
              "--mesh", "single", "--device", "cpu")
    assert ok.returncode == 0, ok.stderr[-3000:]
    assert "0 ok / 1 skip / 0 fail" in ok.stdout
    rec = json.loads((tmp_path / "qwen3-1.7b__long_500k__single.json")
                     .read_text())
    assert rec["status"] == "skip"
    # an unknown cache dtype fails the cell: recorded, and exit 1
    bad = _cli(tmp_path, "--arch", "qwen3-1.7b", "--shape", "decode_32k",
               "--mesh", "single", "--device", "cpu", "--cache-dtype",
               "no_such_dtype")
    assert bad.returncode == 1
    assert "0 ok / 0 skip / 1 fail" in bad.stdout
    rec = json.loads((tmp_path / "qwen3-1.7b__decode_32k__single.json")
                     .read_text())
    assert rec["status"] == "fail" and "no_such_dtype" in rec["error"]


# ----------------------------------------------------------------------
# the placed step on gloo ranks
# ----------------------------------------------------------------------

PLACED = r'''
import contextlib

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.dist.fl_step import (_argmax_vocab, make_fl_train_step,
                                      make_serve_step)
from repro_torch.launch import specs
from repro_torch.launch.dryrun import fake_and_real
from repro_torch.models import init_decode_cache, init_params, prefill
from repro_torch.optim import adamw_init
from repro_torch.optim.schedules import constant_lr
from repro_torch.sharding import api as sapi

sapi.ZERO_MIN_ELEMS = 1024          # reduced weights split over data too


def full(tree):
    return tree_map(lambda t: t.full_tensor() if sapi.is_dtensor(t) else t,
                    tree)


def local_bytes(tree):
    return sum((t.to_local() if sapi.is_dtensor(t) else t).numel()
               * t.element_size() for t in leaves(tree))


def run(cfg, mesh, params0, batch, n_pods, placed):
    params = tree_map(torch.clone, params0)
    if placed:
        sub = mesh.submesh(("data", "model"))
        params = sapi.distribute_tree(params, sapi.param_specs(params, mesh),
                                      sub)
    opt = adamw_init(params)
    lb = local_bytes(params)
    step = make_fl_train_step(cfg, mesh, lr_schedule=constant_lr(LR),
                              n_pods=n_pods)
    p2, o2, met = step(params, opt, batch, torch.ones(n_pods),
                       torch.ones(n_pods))
    return dict(params=flat(full(p2)), opt=flat(full(o2)),
                loss=float(met["loss"]), local_bytes=lb)


def serve_run(cfg, mesh, params0, prompt, n_new):
    """Prefill ``prompt``, then ``n_new`` greedy decode steps; the
    logits, tokens and filled caches of every step.  With a mesh the
    prefill takes the prefill cell's placements (ZeRO on) and fills
    caches placed by ``cache_specs``, the decode steps the decode
    cell's (``decode_rules``), as the dry run traces them."""
    b, t = prompt.shape
    max_len = t + n_new
    serve = make_serve_step(cfg)
    res = dict(logits=[], tokens=[])
    if mesh is None:
        logits, caches = prefill(cfg, params0, prompt, max_len=max_len)
        tok, params, rules = torch.argmax(logits, -1), params0, None
    else:
        rules = dict(sapi.DEFAULT_RULES)
        caches = init_decode_cache(cfg, b, max_len)
        caches = sapi.distribute_tree(
            caches, specs.cache_specs(cfg, caches, mesh, b), mesh)
        with sapi.axis_rules(rules, mesh):
            params = sapi.distribute_tree(
                params0, sapi.param_specs(params0, mesh, rules), mesh)
            x = sapi.distribute(prompt, (specs._batch_axes(mesh, b), None),
                                mesh)
            logits, caches = prefill(cfg, params, x, max_len=max_len,
                                     caches=caches)
            tok = _argmax_vocab(logits)
        rules = specs.decode_rules(cfg, mesh, rules)
        params = sapi.distribute_tree(
            params0, sapi.param_specs(params0, mesh, rules), mesh)
    res["caches"] = flat(full(caches))
    res["logits"].append(full(logits))
    res["tokens"].append(full(tok))
    ctx = (contextlib.nullcontext() if mesh is None
           else sapi.axis_rules(rules, mesh))
    with ctx:
        for i in range(n_new):
            tok, logits, caches = serve(params, caches, tok, t + i)
            res["logits"].append(full(logits))
            res["tokens"].append(full(tok))
    return res


def counts(cc):
    return dict(flops=cc.costs.flops, hbm_bytes=cc.costs.hbm_bytes,
                transcendentals=cc.costs.transcendentals,
                coll_bytes=cc.costs.coll_bytes,
                coll_counts=cc.costs.coll_counts, n_ops=cc.n_ops,
                op_counts=cc.op_counts, memory=cc.final_memory)


b = {k: torch.as_tensor(v) for k, v in batches(2, 4, 16, 7, 1)[0].items()}
if world == 4:
    mesh = make_pod_mesh(1, data=2, model=2)
    out["coords"] = mesh.coords
    with torch.no_grad():
        for name, kw in SERVE_CFGS:
            cfg = get_config("qwen3-1.7b", reduced=True).replace(**kw)
            params0 = init_params(cfg, gen(13))
            prompt = torch.as_tensor(
                np.random.default_rng(5).integers(0, cfg.vocab, (2, 8)))
            caches = init_decode_cache(cfg, 2, 8 + N_NEW, device="meta")
            out["serve", name] = dict(
                placed=serve_run(cfg, mesh, params0, prompt, N_NEW),
                plain=serve_run(cfg, None, params0, prompt, N_NEW),
                cache_specs=specs.cache_specs(cfg, caches, mesh, 2))
    res = fake_and_real(get_config("qwen3-1.7b", reduced=True),
                        ShapeSpec(*FIDELITY_SHAPE), device="cpu", mesh=mesh)
    out["fidelity"] = dict(fake=counts(res["fake"]),
                           real=counts(res["real"]))
    del res
    for arch in PLACED_ARCHS:
        cfg = get_config(arch, reduced=True).replace(dtype="float32")
        bb = {k: v[:1] % cfg.vocab for k, v in b.items()}
        params0 = init_params(cfg, gen(11))
        out[arch] = dict(
            params0=params0 if rank == 0 else None,
            specs=sapi.param_specs(params0, mesh),
            batch=bb,
            replicated=run(cfg, mesh, params0, bb, 1, False),
            placed=run(cfg, mesh, params0, bb, 1, True))
else:
    cfg = get_config("qwen3-1.7b", reduced=True).replace(dtype="float32")
    bb = {k: v % cfg.vocab for k, v in b.items()}
    params0 = init_params(cfg, gen(12))
    mesh = make_pod_mesh(2, data=2, model=2)
    out["placed"] = run(cfg, mesh, params0, bb, 2, True)
    if rank == 0:
        out["single"] = run(cfg, None, params0, bb, 2, False)
'''


def _spawn_placed(tmp_path, world):
    pre = (f"PLACED_ARCHS = {PLACED_ARCHS!r}\nLR = {LR!r}\n"
           f"SERVE_CFGS = {SERVE_CFGS!r}\nN_NEW = {N_NEW!r}\n"
           f"FIDELITY_SHAPE = {FIDELITY_SHAPE!r}\n")
    return ranks._spawn(tmp_path, world, pre + PLACED)


@pytest.fixture(scope="module")
def placed4(tmp_path_factory):
    return _spawn_placed(tmp_path_factory.mktemp("placed4"), 4)


@pytest.fixture(scope="module")
def placed8(tmp_path_factory):
    return _spawn_placed(tmp_path_factory.mktemp("placed8"), 8)


def _tol(arch):
    return MOE_TOL if arch == "olmoe-1b-7b" else PLACED_TOL


@pytest.mark.parametrize("arch", PLACED_ARCHS)
def test_placed_step_matches_replicated(placed4, arch):
    """DTensor parameters on the 2 x 2 grid: the loss, the gathered
    parameters and optimizer state after one step equal the replicated
    step's on the same grid, on every rank."""
    for r in range(4):
        got, want = placed4[r][arch]["placed"], placed4[r][arch]["replicated"]
        assert abs(got["loss"] - want["loss"]) < _tol(arch)
        np.testing.assert_allclose(got["params"].numpy(),
                                   want["params"].numpy(), atol=_tol(arch),
                                   rtol=0)
        np.testing.assert_allclose(got["opt"].numpy(), want["opt"].numpy(),
                                   atol=_tol(arch), rtol=0)
        assert torch.equal(got["params"], placed4[0][arch]["placed"][
            "params"])


@pytest.mark.parametrize("arch", PLACED_ARCHS)
def test_placed_loss_matches_jax(placed4, arch):
    """The placed step's loss is JAX's ``train_loss`` of the same
    weights (carried across by ``repro_torch.interop``) on the batch."""
    from repro.models import train_loss as jtrain_loss
    from repro_torch.interop import to_numpy
    res = placed4[0][arch]
    jcfg = jget_config(arch, reduced=True).replace(dtype="float32")
    jp = jax.tree_util.tree_map(jnp.asarray, to_numpy(res["params0"]))
    want = float(jtrain_loss(jcfg, jp, jnp.asarray(res["batch"]["inputs"][0]
                                                   .numpy()),
                             jnp.asarray(res["batch"]["labels"][0].numpy())))
    assert abs(res["placed"]["loss"] - want) < _tol(arch)


@pytest.mark.parametrize("arch", PLACED_ARCHS)
def test_placed_parameter_bytes(placed4, arch):
    """Each rank holds its parameters' bytes as the placements divide
    them: a leaf's bytes over the product of its axes' sizes (2 each)."""
    from repro_torch.tree import leaves
    res = placed4[0][arch]
    want = 0
    for leaf, spec in zip(leaves(res["params0"]), _spec_leaves(res["specs"])):
        split = 1
        for entry in spec:
            split *= 2 ** len(entry if isinstance(entry, tuple) else
                              ([entry] if entry else []))
        want += leaf.numel() * leaf.element_size() // split
    assert any(s != (None,) * len(s) and "data" in str(s)
               for s in _spec_leaves(res["specs"]))      # ZeRO took part
    for r in range(4):
        assert placed4[r][arch]["placed"]["local_bytes"] == want
    full = sum(leaf.numel() * leaf.element_size()
               for leaf in leaves(res["params0"]))
    assert placed4[0][arch]["replicated"]["local_bytes"] == full > want


@pytest.mark.parametrize("name", [n for n, _ in SERVE_CFGS])
def test_placed_serving_matches_plain(placed4, name):
    """Placed serving on the 2 x 2 grid: the prefill (its caches placed
    by ``cache_specs``, filled on the shards) and three greedy decode
    steps (``make_serve_step``: attention on the shards, the token
    picked by ``_argmax_vocab`` over vocabulary slices) give every rank
    the logits, caches and tokens of the unplaced ``prefill`` and
    serve step, which the JAX package holds.  With one kv head the
    cache splits on head_dim, so decode sums the scores over ``model``
    and the prefill slices the kv head to each rank's query heads."""
    k_spec = placed4[0]["serve", name]["cache_specs"]["cycles"]["slot0"]["k"]
    # (layer, batch, kv heads, seq, head_dim): kv heads or head_dim
    assert k_spec[2:] == ((None, None, "model") if name.endswith("kv1")
                          else ("model", None, None))
    want = placed4[0]["serve", name]["plain"]
    assert len(want["tokens"]) == 1 + N_NEW
    for r in range(4):
        got = placed4[r]["serve", name]["placed"]
        np.testing.assert_allclose(got["caches"].numpy(),
                                   want["caches"].numpy(), atol=PLACED_TOL,
                                   rtol=0)
        for g, w in zip(got["logits"], want["logits"]):
            np.testing.assert_allclose(g.numpy(), w.numpy(),
                                       atol=PLACED_TOL, rtol=0)
        for g, w in zip(got["tokens"], want["tokens"]):
            assert torch.equal(g.long(), w.long())


_COUNT_KEYS = ("flops", "transcendentals", "hbm_bytes", "coll_bytes",
               "coll_counts", "n_ops")


def test_placed_step_fake_counts_equal_real(placed4):
    """The counter on DTensor parameters (``fake_and_real`` on the 2 x 2
    grid): the fake trace and the real step of reduced qwen3-1.7b count
    the same FLOPs, bytes, ops, collectives and memory on every rank:
    DTensor's logical ops and its sharding propagation declined, local
    shards tracked, collectives counted on real groups."""
    for r in range(4):
        fake = placed4[r]["fidelity"]["fake"]
        real = placed4[r]["fidelity"]["real"]
        assert real["flops"] > 0 and real["coll_bytes"] > 0
        assert real["coll_counts"].get("all-gather", 0) > 0
        assert fake == real


def test_dry_run_cell_counts_equal_a_real_placed_step(placed4, tmp_path):
    """``run_cell``, the grid's own path, traces the same cell on a fake
    (1, 2, 2) world: its record's counts and memory equal rank 0's real
    placed step on the gloo grid."""
    prog = (
        "import json\n"
        "from repro_torch.sharding import api as sapi\n"
        "sapi.ZERO_MIN_ELEMS = 1024\n"
        "from repro_torch.configs.base import ShapeSpec\n"
        "from repro_torch.launch.dryrun import run_cell\n"
        "rec = run_cell('qwen3-1.7b', 'train_4k', False, "
        f"shape=ShapeSpec(*{FIDELITY_SHAPE!r}), reduced=True, "
        "mesh_shape=(1, 2, 2), device='cpu', verbose=False)\n"
        "print('RESULT ' + json.dumps(rec))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", prog], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    rec = json.loads([ln for ln in proc.stdout.splitlines()
                      if ln.startswith("RESULT ")][-1][len("RESULT "):])
    assert rec["status"] == "ok" and rec["n_chips"] == 4
    real = placed4[0]["fidelity"]["real"]
    assert {k: rec["cost"][k] for k in _COUNT_KEYS} == {
        k: real[k] for k in _COUNT_KEYS}
    assert rec["memory"] == real["memory"]


def test_placed_pod_step_matches_single_process(placed8):
    """The 8-rank ``pod`` x ``data`` x ``model`` step with DTensor
    parameters on each pod's 2 x 2 sub-mesh, the ring carrying local
    shards, equals the single-process ``n_pods = 2`` step."""
    want = placed8[0]["single"]
    for r in range(8):
        got = placed8[r]["placed"]
        assert abs(got["loss"] - want["loss"]) < PLACED_TOL
        np.testing.assert_allclose(got["params"].numpy(),
                                   want["params"].numpy(), atol=PLACED_TOL,
                                   rtol=0)
        np.testing.assert_allclose(got["opt"].numpy(), want["opt"].numpy(),
                                   atol=PLACED_TOL, rtol=0)
