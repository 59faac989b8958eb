"""The port's multi-rank layer over real ``torch.distributed`` ranks.

Each fixture spawns gloo ranks on the CPU (one process a rank, one
thread each); they meet at a ``file://`` rendezvous under ``tmp_path``,
never at a fixed port, run the port's code and ``torch.save`` what
they computed.  The tests then hold those results here, beside the JAX
package:

- the torrent ring (``torrent_fedavg(mesh=)``; P = 2 and 4, n_blocks
  1, 3 and 4, compressed or not): within 2e-5 of JAX's
  ``torrent_fedavg`` and of the FedAvg oracle; every rank's aggregate
  bit-identical to every other's and to the single-device path; the
  compressed payloads exactly ``repro.kernels.ref``'s codes times its
  scales; (P - 1) x n_blocks (+ P - 1 scale) sends and receives a rank;
  zero mass gives zeros; a masked NaN row does not poison the result;
  a tensor on the wrong kind of device is refused;
- the pod-parallel FL step within 2e-5 of the single-process
  ``n_pods = 4`` step, data-parallel equality within 1e-4, the
  straggler mask within 1e-6 and the zero-mass no-op exactly (as the
  reference's ``tests/test_dist_multidevice.py:82`` and ``:115``);
- the expert-parallel MoE on a 2 x 4 ``data`` x ``model`` grid against
  ``_moe_ffn``, outputs and gradients within 1e-4; and the gradients of
  ``train_loss`` with remat on that grid, its backward on another
  thread (as autograd runs it on the card), against the single-device
  ones (also over NCCL, where two or more GPUs are present);
- the elastic drill through ``torch.distributed.run``;
- one ``dist`` test holds the 4-rank ring to JAX's own 4-pod mesh
  (the XLA fake-device subprocess harness).

Every spawned process has its own timeout.
"""
import os
import subprocess
import sys
import textwrap
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.launch import train as ttrain  # noqa: E402

# The JAX package is imported inside the tests that compare with it, so
# that the NCCL test runs on a GPU machine without JAX.

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300                   # seconds a spawned process may take
RING_TOL = 2e-5
STEP_TOL = 2e-5
DP_TOL = 1e-4
MOE_TOL = 1e-4
NBLOCKS = (1, 3, 4)

# Inputs made from seeds with numpy: run in every rank and here.
COMMON = r'''
import numpy as np

WEIGHTS = [1.0, 2.0, 3.0, 4.0]
ACTIVE = [1.0, 1.0, 0.0, 1.0]
CFG_KW = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
              n_kv=2, head_dim=8, d_ff=64, vocab=128, qk_norm=True,
              dtype="float32", remat=False)
MOE_KW = dict(name="m", family="moe", n_layers=1, d_model=64, n_heads=4,
              n_kv=4, head_dim=16, d_ff=0, vocab=128, pattern=("moe",),
              n_experts=8, top_k=2, d_expert=32, capacity_factor=8.0,
              dtype="float32")


def updates(p, seed):
    rng = np.random.default_rng(seed)
    return {
        "layer": {"w": rng.normal(size=(p, 16, 8)).astype(np.float32),
                  "b": rng.normal(size=(p, 24)).astype(np.float32)},
        "head": rng.normal(size=(p, 7, 3, 2)).astype(np.float32),
        "tail": [rng.normal(size=(p, 5)).astype(np.float32)],
    }


def ring_seed(p, nb):
    return 10 * p + nb


def batches(p, b, t, seed, n):
    rng = np.random.default_rng(seed)
    return [{"inputs": rng.integers(0, 128, size=(p, b, t)),
             "labels": rng.integers(0, 128, size=(p, b, t))}
            for _ in range(n)]
'''

RANK_PROLOGUE = r'''
import sys

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import (init_distributed, make_host_mesh,
                                     make_pod_mesh)
from repro_torch.tree import leaves, tree_map

rank, world, tmp, device = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                             sys.argv[4])
torch.set_num_threads(1)
dev = init_distributed(device, init_method=f"file://{tmp}/rendezvous",
                       rank=rank, world_size=world)
out = {}


def flat(tree):
    return torch.cat([l.detach().reshape(-1).float() for l in leaves(tree)])


def gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g
'''

RANK_EPILOGUE = r'''
torch.save(out, f"{tmp}/rank{rank}.pt")
dist.barrier()
dist.destroy_process_group()
'''

# Four ranks: the rings (P = 2 over ranks 0-1, P = 4), the pod step,
# data parallelism.
RANKS4 = r'''
from repro_torch.dist import torrent
from repro_torch.dist.fl_step import make_fl_train_step
from repro_torch.models import ArchConfig, init_params
from repro_torch.optim import adamw_init
from repro_torch.optim.schedules import constant_lr

for p in (2, 4):
    mesh = make_pod_mesh(p)             # every rank builds the groups
    if not mesh.is_member:
        continue
    me = mesh.coords["pod"]
    w, a = torch.tensor(WEIGHTS[:p]), torch.tensor(ACTIVE[:p])
    for nb in NBLOCKS:
        ups = tree_map(torch.from_numpy, updates(p, ring_seed(p, nb)))
        for comp in (False, True):
            torrent.reset_p2p()
            agg = torrent.torrent_fedavg(ups, w, a, mesh=mesh, n_blocks=nb,
                                         compress=comp)
            counts = dict(torrent.P2P)
            blocks, _ = torrent._flatten_updates(
                torrent.take_pods(ups, [me]), nb)
            gathered, = torrent.ring_gather(
                torrent.GroupTransport.for_mesh(mesh), [blocks[0]],
                compress=comp)
            out["ring", p, nb, comp] = dict(
                agg=flat(agg), counts=counts, gathered=gathered,
                single=flat(torrent.torrent_fedavg(
                    ups, w, a, n_blocks=nb, compress=comp)))
    ups = tree_map(torch.from_numpy, updates(p, 99))
    out["zero", p] = [flat(torrent.torrent_fedavg(ups, w, torch.zeros(p),
                                                  mesh=mesh)),
                      flat(torrent.torrent_fedavg(ups, torch.zeros(p),
                                                  torch.ones(p), mesh=mesh))]
    nan_a = torch.ones(p)
    nan_a[-1] = 0.0
    nan = tree_map(torch.clone, ups)
    for l in leaves(nan):
        l[-1] = float("nan")
    out["nan", p] = [flat(torrent.torrent_fedavg(nan, w, nan_a, mesh=mesh,
                                                 compress=comp))
                     for comp in (False, True)]
    out["nan_want", p] = [flat(torrent.torrent_fedavg(
        nan, w, nan_a, compress=comp)) for comp in (False, True)]
    if p == 4:
        transport = torrent.GroupTransport.for_mesh(mesh)
        tried = ["meta"] + (["cuda"] if torch.cuda.is_available() else [])
        refused = []
        for dev in tried:
            t = torch.zeros(3, device=dev)
            try:
                transport.shift([[t]], [[t]])
            except ValueError as e:
                refused.append((dev, str(e)))
        out["refused"] = (tried, refused)

cfg = ArchConfig(**CFG_KW)
mesh = make_pod_mesh(4)
w4 = torch.tensor(WEIGHTS)
for comp in (False, True):
    runs = {}
    for label, m in (("ring", mesh), ("single", None)):
        if label == "single" and rank != 0:
            continue
        params = init_params(cfg, gen(0))
        opt = adamw_init(params)
        step = make_fl_train_step(cfg, m, lr_schedule=constant_lr(1e-2),
                                  n_pods=4, compress=comp)
        losses = []
        for b in batches(4, 2, 8, 1, 2):
            params, opt, met = step(params, opt,
                                    tree_map(torch.as_tensor, b), w4,
                                    torch.tensor(ACTIVE))
            losses.append(float(met["loss"]))
        runs[label] = dict(state=flat((params, opt)), losses=losses)
    out["step", comp] = runs

step = make_fl_train_step(cfg, mesh, lr_schedule=constant_lr(1e-3),
                          n_pods=4)
b = tree_map(torch.as_tensor, batches(4, 4, 16, 3, 1)[0])
params = init_params(cfg, gen(1))
res = []
for corrupt in (False, True):
    bb = dict(b, inputs=b["inputs"].clone())
    if corrupt:
        bb["inputs"][3] = 0
    p2, _, _ = step(tree_map(torch.clone, params),
                    adamw_init(params), bb, torch.ones(4),
                    torch.tensor([1.0, 1.0, 1.0, 0.0]))
    res.append(flat(p2))
out["straggler"] = res
opt = adamw_init(params)
before = flat((params, opt))
p2, o2, _ = step(params, opt, b, torch.ones(4), torch.zeros(4))
out["zero_mass"] = (before, flat((p2, o2)))

b = batches(2, 4, 16, 4, 1)[0]
params = init_params(cfg, gen(2))
for label, m, n_pods, bt in (
        ("pods2_data2", make_pod_mesh(2, data=2), 2, b),
        ("data4", make_host_mesh((4, 1), ("data", "model")), 1,
         {k: v.reshape(1, 8, 16) for k, v in b.items()})):
    step = make_fl_train_step(cfg, m, lr_schedule=constant_lr(1e-3),
                              n_pods=n_pods)
    p2, _, met = step(tree_map(torch.clone, params), adamw_init(params),
                      tree_map(torch.as_tensor, bt), torch.ones(n_pods),
                      torch.ones(n_pods))
    out["dp", label] = (flat(p2), float(met["loss"]))
if rank == 0:
    step = make_fl_train_step(cfg, None, lr_schedule=constant_lr(1e-3),
                              n_pods=1)
    p2, _, met = step(tree_map(torch.clone, params), adamw_init(params),
                      tree_map(torch.as_tensor,
                               {k: v.reshape(1, 8, 16) for k, v in b.items()}),
                      torch.ones(1), torch.ones(1))
    out["dp", "single"] = (flat(p2), float(met["loss"]))
'''

# ``train_loss`` of a remat MoE model on ``mesh``, a (data, model) grid of
# ``dev``s, against the single-device loss on rank 0.  Autograd runs the
# backward of CUDA tensors, and with it the checkpoints' recomputation,
# on a device thread of its own: the backward runs on a thread of its own
# here too, so the CPU meets what the card meets.
MOE_REMAT = r'''
import contextlib
import threading

from repro_torch.models import ArchConfig, init_params, train_loss
from repro_torch.sharding.api import DEFAULT_RULES, axis_rules

rcfg = ArchConfig(**dict(MOE_KW, n_layers=2, remat=True))
rparams = tree_map(lambda t: t.to(dev), init_params(rcfg, gen(3)))
rbatch = {k: torch.as_tensor(v[0], device=dev)
          for k, v in batches(1, 4, 16, 5, 1)[0].items()}


def remat_grads(rows, ctx):
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), rparams)
    with ctx:
        loss = train_loss(rcfg, p, rbatch["inputs"][rows],
                          rbatch["labels"][rows])
    err = []

    def backward():
        try:
            loss.backward()
        except Exception as e:          # noqa: BLE001 - reported below
            err.append(repr(e))

    th = threading.Thread(target=backward)
    th.start()
    th.join()
    if err:
        return err[0]
    return flat(tree_map(lambda t: t.grad, p)).cpu()


d = mesh.coords["data"]
out["remat"] = remat_grads(slice(2 * d, 2 * d + 2),
                           axis_rules(DEFAULT_RULES, mesh))
if rank == 0:
    out["remat_single"] = remat_grads(slice(0, 4), contextlib.nullcontext())
out["coords"] = mesh.coords
'''

# Eight ranks: the expert-parallel MoE on a 2 x 4 data x model grid.
RANKS8 = r'''
from repro_torch.models import ArchConfig
from repro_torch.models.layers import _moe_ffn, _moe_ffn_ep, init_layer
from repro_torch.sharding.api import DEFAULT_RULES, axis_rules

cfg = ArchConfig(**MOE_KW)
mesh = make_host_mesh((2, 4), ("data", "model"))
p0 = init_layer(cfg, "moe", gen(0), "cpu")
h = torch.randn((4, 16, 64), generator=gen(1))
cot = torch.randn((4, 16, 64), generator=gen(2))
names = ("router", "moe_gate", "moe_up", "moe_down")


def run(h_in, ctx):
    p = {k: v.clone().requires_grad_(k in names) for k, v in p0.items()}
    x = h_in.clone().requires_grad_(True)
    with ctx:
        y = _moe_ffn(cfg, p, x)
    took_ep = x.shape[0] == 2 and _moe_ffn_ep(cfg, p, x, mesh) is not None
    rows = slice(0, x.shape[0]) if x.shape[0] == 4 else \
        slice(2 * mesh.coords["data"], 2 * mesh.coords["data"] + 2)
    (y * cot[rows]).sum().backward()
    return dict(out=y.detach(), x=x.grad,
                **{k: p[k].grad for k in names}), took_ep


d = mesh.coords["data"]
got, took = run(h[2 * d:2 * d + 2], axis_rules(DEFAULT_RULES, mesh))
out["ep"] = got
out["took_ep"] = took
if rank == 0:
    import contextlib
    out["single"], _ = run(h, contextlib.nullcontext())
''' + MOE_REMAT


def _spawn(tmp_path, world: int, body: str, device: str = "cpu") -> list:
    """Run ``body`` in ``world`` ranks (gloo on the CPU, NCCL with one
    GPU a rank on ``"cuda"``); their ``out`` dicts.  Once a rank fails
    (or ``TIMEOUT`` passes) the others are killed: a rank blocked in a
    collective whose peer died would wait out the backend's own
    timeout."""
    prog = "\n".join([COMMON, f"NBLOCKS = {NBLOCKS!r}", RANK_PROLOGUE,
                      body, RANK_EPILOGUE])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    logs = [open(tmp_path / f"rank{r}.log", "w") for r in range(world)]
    procs = []
    deadline = time.monotonic() + TIMEOUT
    try:
        procs = [subprocess.Popen(
            [sys.executable, "-c", prog, str(r), str(world), str(tmp_path),
             device],
            env=env, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(world)]
        while True:
            codes = [p.poll() for p in procs]
            if (all(c is not None for c in codes)
                    or any(c not in (None, 0) for c in codes)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.1)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs:
            f.close()
    errs = [f"rank {r} exited {c}:\n"
            + (tmp_path / f"rank{r}.log").read_text()[-3000:]
            for r, c in enumerate(codes) if c != 0]
    assert not errs, "\n".join(errs)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def test_mesh_in_one_process_matches_the_reference():
    """Without a process group the world is this process: a mesh of
    one rank builds (no groups), a larger one raises the JAX package's
    ``ValueError``."""
    from repro.launch import mesh as jmesh
    from repro_torch.launch import mesh as tmesh
    one = tmesh.make_pod_mesh(1)
    assert one.is_member and one.groups == {} and one.shape == {
        "pod": 1, "data": 1, "model": 1}
    assert tmesh.pod_axis_size(one) == 1
    host = tmesh.make_host_mesh()
    assert host.axis_names == ("data", "model") and host.coords == {
        "data": 0, "model": 0}
    for kw in ({"n_pods": 2}, {"n_pods": 1, "data": 2, "model": 2}):
        with pytest.raises(ValueError) as want:
            jmesh.make_pod_mesh(**kw)
        with pytest.raises(ValueError) as got:
            tmesh.make_pod_mesh(**kw)
        assert str(got.value) == str(want.value)


def _common():
    ns: dict = {}
    exec(COMMON, ns)
    return ns


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("ranks4"), 4, RANKS4)


@pytest.fixture(scope="module")
def ranks8(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("ranks8"), 8, RANKS8)


def _jax_flat(tree):
    import jax
    return np.concatenate([np.asarray(l, np.float32).reshape(-1)
                           for l in jax.tree_util.tree_leaves(tree)])


def _rows(ups, nb):
    """JAX's (P, n_blocks, db) blocks of the updates."""
    from repro.dist import torrent as jtorrent
    return np.asarray(jtorrent._flatten_updates(
        {k: v for k, v in ups.items()}, nb)[0])


def _ref_codes(blocks):
    """The blocks as ``repro.kernels.ref``'s codes times its scales."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    q, s = jref.chunk_quantize(jnp.asarray(blocks.reshape(-1,
                                                          blocks.shape[2])))
    return np.asarray(jref.chunk_dequantize(q, s)).reshape(blocks.shape)


RING_CASES = [(p, nb, comp) for p in (2, 4) for nb in NBLOCKS
              for comp in (False, True)]


@pytest.mark.parametrize("p,nb,comp", RING_CASES)
def test_ring_matches_jax(ranks4, p, nb, comp):
    import jax.numpy as jnp
    from repro.dist import torrent as jtorrent
    c = _common()
    ups = c["updates"](p, c["ring_seed"](p, nb))
    w = np.array(c["WEIGHTS"][:p], np.float32)
    a = np.array(c["ACTIVE"][:p], np.float32)
    want = _jax_flat(jtorrent.torrent_fedavg(
        ups, jnp.asarray(w), jnp.asarray(a), n_blocks=nb, compress=comp))
    blocks = _rows(ups, nb)
    if comp:                            # the oracle on the codes' values
        blocks = _ref_codes(blocks)
    wn = w * a / (w * a).sum()
    oracle = np.einsum("p,pd->d", wn, blocks.reshape(p, -1))
    for r in range(p):
        got = ranks4[r]["ring", p, nb, comp]["agg"].numpy()
        np.testing.assert_allclose(got, want, atol=RING_TOL, rtol=RING_TOL)
        np.testing.assert_allclose(got, oracle[:got.size], atol=RING_TOL,
                                   rtol=RING_TOL)


@pytest.mark.parametrize("p,nb,comp", RING_CASES)
def test_ring_ranks_bit_identical(ranks4, p, nb, comp):
    first = ranks4[0]["ring", p, nb, comp]["agg"]
    for r in range(p):
        res = ranks4[r]["ring", p, nb, comp]
        assert torch.equal(res["agg"], first)
        assert torch.equal(res["agg"], res["single"])
    for r in range(p, 4):               # outside the P = 2 mesh
        assert ("ring", p, nb, comp) not in ranks4[r]


@pytest.mark.parametrize("p,nb,comp", RING_CASES)
def test_ring_p2p_schedule(ranks4, p, nb, comp):
    """(P - 1) x n_blocks block sends (+ P - 1 scale sends) a rank, the
    port's counterpart of ``test_torrent_collective_schedule_in_hlo``;
    the ring was run twice (through ``torrent_fedavg``, then
    ``ring_gather``) and the count read after the first."""
    want = (p - 1) * (nb + comp)
    for r in range(p):
        counts = ranks4[r]["ring", p, nb, comp]["counts"]
        assert counts == {("send", r): want, ("recv", r): want}


@pytest.mark.parametrize("p,nb", [(p, nb) for p in (2, 4)
                                  for nb in NBLOCKS])
def test_ring_payloads_are_the_reference_codes(ranks4, p, nb):
    """Every rank's gathered buffer: row u is pod u's update, and with
    compression exactly ``repro.kernels.ref``'s codes times its scales
    (quantized once at the source, circulated losslessly)."""
    c = _common()
    blocks = _rows(c["updates"](p, c["ring_seed"](p, nb)), nb)
    deq = _ref_codes(blocks)
    for r in range(p):
        plain = ranks4[r]["ring", p, nb, False]["gathered"].numpy()
        comp = ranks4[r]["ring", p, nb, True]["gathered"].numpy()
        np.testing.assert_array_equal(plain, blocks)
        np.testing.assert_array_equal(comp, deq)


@pytest.mark.parametrize("p", [2, 4])
def test_ring_zero_mass_returns_zeros(ranks4, p):
    for r in range(p):
        for agg in ranks4[r]["zero", p]:
            assert not torch.isnan(agg).any()
            assert (agg == 0).all()


@pytest.mark.parametrize("p", [2, 4])
def test_ring_masked_nan_row(ranks4, p):
    for r in range(p):
        for got, want in zip(ranks4[r]["nan", p], ranks4[r]["nan_want", p]):
            assert torch.isfinite(got).all()
            assert torch.equal(got, want)


def test_gloo_refuses_a_tensor_off_the_cpu(ranks4):
    """On the CPU a ``meta`` tensor stands for one off the CPU; where a
    GPU is present a CUDA tensor is tried too."""
    tried, refused = ranks4[0]["refused"]
    assert [d for d, _ in refused] == tried and tried[0] == "meta"
    assert all("gloo" in msg for _, msg in refused)


@pytest.mark.parametrize("comp", [False, True])
def test_pod_step_matches_single_process(ranks4, comp):
    single = ranks4[0]["step", comp]["single"]
    for r in range(4):
        got = ranks4[r]["step", comp]["ring"]
        assert torch.equal(got["state"], ranks4[0]["step", comp]["ring"][
            "state"])
        np.testing.assert_allclose(got["state"].numpy(),
                                   single["state"].numpy(), atol=STEP_TOL,
                                   rtol=0)
        np.testing.assert_allclose(got["losses"], single["losses"],
                                   atol=STEP_TOL, rtol=0)
        assert np.isfinite(got["losses"]).all()


def test_pod_step_straggler_mask(ranks4):
    for r in range(4):
        ref, alt = ranks4[r]["straggler"]
        assert float((ref - alt).abs().max()) < 1e-6


def test_pod_step_zero_mass_is_a_noop(ranks4):
    for r in range(4):
        before, after = ranks4[r]["zero_mass"]
        assert torch.equal(before, after)


@pytest.mark.parametrize("label", ["pods2_data2", "data4"])
def test_data_parallel_equals_single_process(ranks4, label):
    """Full participation, equal weights: FedAvg over pods of
    data-parallel gradients == one process's SGD on the whole batch."""
    want, want_loss = ranks4[0]["dp", "single"]
    for r in range(4):
        got, loss = ranks4[r]["dp", label]
        assert torch.equal(got, ranks4[0]["dp", label][0])
        assert float((got - want).abs().max()) < DP_TOL
        assert abs(loss - want_loss) < DP_TOL


@pytest.mark.parametrize("what", ["out", "x", "router", "moe_gate", "moe_up",
                                  "moe_down"])
def test_expert_parallel_moe_matches_moe_ffn(ranks8, what):
    """Each (data, model) rank's outputs and input gradient are its data
    shard's rows of the single-device ones; the router's and experts'
    gradients, summed over the data ranks (the FL step's data
    all_reduce), equal the single-device ones on every model rank."""
    single = ranks8[0]["single"][what]
    assert all(r["took_ep"] for r in ranks8)
    per_data: dict = {}
    for r in ranks8:
        d = r["coords"]["data"]
        got = r["ep"][what]
        if what in ("out", "x"):
            np.testing.assert_allclose(got.numpy(),
                                       single[2 * d:2 * d + 2].numpy(),
                                       atol=MOE_TOL, rtol=MOE_TOL)
        else:
            per_data.setdefault(r["coords"]["model"], []).append(got)
    for grads in per_data.values():
        np.testing.assert_allclose(sum(grads).numpy(), single.numpy(),
                                   atol=MOE_TOL, rtol=MOE_TOL)


def _check_remat_grads(res):
    """Each rank's gradient, averaged over the data ranks, equals the
    single-device one on every model rank."""
    single = res[0]["remat_single"]
    assert all(not isinstance(r["remat"], str) for r in res), [
        r["remat"] for r in res if isinstance(r["remat"], str)]
    per_model: dict = {}
    for r in res:
        per_model.setdefault(r["coords"]["model"], []).append(r["remat"])
    for grads in per_model.values():
        np.testing.assert_allclose((sum(grads) / len(grads)).numpy(),
                                   single.numpy(), atol=MOE_TOL,
                                   rtol=MOE_TOL)


def test_expert_parallel_remat_backward_on_another_thread(ranks8):
    """``train_loss`` of a remat MoE model on the 2 x 4 grid, its
    backward on a thread without the ``axis_rules`` binding (as CUDA's
    autograd runs it): the recomputation takes the forward's
    expert-parallel route and the gradients are the single-device
    ones."""
    _check_remat_grads(ranks8)


@pytest.mark.cuda
def test_expert_parallel_remat_over_nccl(tmp_path):
    """The same over NCCL, one GPU a rank: a 2 x (GPUs // 2) grid of up
    to 4 GPUs, where autograd's device thread runs the backward."""
    gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if gpus < 2:
        pytest.skip("needs two or more NVIDIA GPUs (one NCCL rank a GPU)")
    world = min(gpus, 4) // 2 * 2
    body = ("mesh = make_host_mesh((2, world // 2), ('data', 'model'))\n"
            + MOE_REMAT)
    _check_remat_grads(_spawn(tmp_path, world, body, device="cuda"))


def _drill(tmp_path, argv):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
           *argv, "--device", "cpu", "--ckpt", str(tmp_path / "ckpt"),
           "--dist-init", f"file://{tmp_path}/rendezvous"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout


@pytest.mark.parametrize("argv,line", [
    (["--pods", "4", "--drop-pod", "2"], "re-meshing 4 -> 3 pods"),
    (["--pods", "3", "--join-pod", "1"], "re-meshing 3 -> 4 pods")])
def test_elastic_drill_over_ranks(tmp_path, capsys, argv, line):
    """The recovery drill over 4 ranks: rank 0 checkpoints, a barrier,
    every rank reads back; the ranks outside the mesh wait.  Its losses
    are the single-process driver's."""
    common = [*argv, "--steps", "6", "--batch", "8", "--seq", "16",
              "--log-every", "1"]
    out = _drill(tmp_path, common)
    assert line in out and "re-mesh continuity ok" in out
    ttrain.main([*common, "--device", "cpu"])
    single = capsys.readouterr().out
    losses = [ln.split("loss ")[1].split()[0] for ln in out.splitlines()
              if "  loss " in ln]
    assert len(losses) == 6
    assert losses == [ln.split("loss ")[1].split()[0]
                      for ln in single.splitlines() if "  loss " in ln]


@pytest.mark.dist
def test_ring_matches_jax_pod_mesh(ranks4, tmp_path):
    """The port's 4-rank ring against JAX's ``torrent_fedavg`` on its
    own 4-pod mesh (4 fake XLA host devices in a subprocess)."""
    prog = COMMON + textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import jax, jax.numpy as jnp
        from repro.dist.torrent import torrent_fedavg
        from repro.sharding.api import AxisType, make_mesh
        mesh = make_mesh((4,), ("pod",), axis_types=(AxisType.Auto,))
        out = {{}}
        for nb in {NBLOCKS!r}:
            ups = updates(4, ring_seed(4, nb))
            for comp in (False, True):
                with mesh:
                    agg = jax.jit(lambda u: torrent_fedavg(
                        u, jnp.asarray(WEIGHTS), jnp.asarray(ACTIVE),
                        mesh=mesh, n_blocks=nb, compress=comp))(ups)
                out[f"{{nb}}_{{int(comp)}}"] = np.concatenate(
                    [np.asarray(l, np.float32).reshape(-1)
                     for l in jax.tree_util.tree_leaves(agg)])
        np.savez({str(tmp_path / "jax.npz")!r}, **out)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", prog], env=env,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-4000:]
    want = np.load(tmp_path / "jax.npz")
    for nb in NBLOCKS:
        for comp in (False, True):
            for r in range(4):
                np.testing.assert_allclose(
                    ranks4[r]["ring", 4, nb, comp]["agg"].numpy(),
                    want[f"{nb}_{int(comp)}"], atol=RING_TOL, rtol=RING_TOL)
