"""The port's per-rank cost counter (``repro_torch.launch.cost_analysis``)
against the JAX package's HLO analysis (``repro/launch/hlo_analysis.py``)
and its tests (``tests/test_hlo_analysis.py``), on the CPU.

The counter sees the ops one rank dispatches, so the JAX checks carry
over as: the loop-free ``x @ w1 -> tanh -> @ w2 -> sum`` within 2% of
the FLOPs JAX's ``analyze`` and XLA's ``cost_analysis`` give; a 13-step
Python loop (JAX's scan) and a nested 4 x 3 loop counted in full; the
ring factors; dtype bytes; the roofline at the H100's constants.  Then
what only the port has: the per-rank count of a DTensor product on a
fake 512-rank world (this rank's shard, not DTensor's logical op nor its
sharding propagation, the same on a repeat), a reduced training cell on
a fake (2, 2, 2) mesh, and the fake trace of a step against the same
step run for real.  Fake worlds run in a subprocess of their own.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import hlo_analysis as H  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import cost_analysis as C  # noqa: E402
from repro_torch.launch.dryrun import fake_and_real  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _count(fn, *args) -> C.Costs:
    with C.CostCounter(fake=False) as cc:
        fn(*args)
    return cc.costs


def _jax_compile(f, *args):
    return jax.jit(f).lower(*args).compile()


def test_loop_free_matches_jax_and_xla():
    def jf(x, w1, w2):
        return (jnp.tanh(x @ w1) @ w2).sum()

    def tf(x, w1, w2):
        return (torch.tanh(x @ w1) @ w2).sum()

    shapes = ((128, 256), (256, 512), (512, 64))
    c = _jax_compile(jf, *(jnp.ones(s) for s in shapes))
    want = H.analyze(c.as_text())
    xla = H.xla_cost_analysis(c)
    got = _count(tf, *(torch.ones(s) for s in shapes))
    assert got.flops == pytest.approx(want.flops, rel=0.02)
    assert got.flops == pytest.approx(xla["flops"], rel=0.02)
    assert got.transcendentals == 128 * 512 == want.transcendentals
    assert got.coll_bytes == 0 and got.coll_counts == {}


def test_loop_is_counted_every_trip():
    """JAX's scan over 13 layers: its body 13 times, not once."""
    w = torch.ones(13, 64, 64)

    def f(x):
        for i in range(13):
            x = x @ w[i]
        return x.sum()

    got = _count(f, torch.ones(64, 64))
    assert got.flops == pytest.approx(13 * 2 * 64 ** 3, rel=0.05)


def test_nested_loop():
    w = torch.ones(4, 3, 32, 32)

    def f(x):
        for i in range(4):
            for j in range(3):
                x = x @ w[i, j]
        return x.sum()

    got = _count(f, torch.ones(32, 32))
    assert got.flops == pytest.approx(12 * 2 * 32 ** 3, rel=0.05)


def test_collective_factors_at_jax_values():
    nb = 8 * 128 * 4                       # f32[8,128], a group of 4
    ins = H.Instr("ag", "f32[8,128]{1,0}", "all-gather",
                  "  %ag = f32[8,128]{1,0} all-gather(%x), channel_id=1, "
                  "replica_groups=[2,4]<=[8], dimensions={0}")
    assert C.collective_bytes("all-gather", nb, 4) == pytest.approx(
        H._collective_bytes(ins)) == pytest.approx(nb * 3 / 4)
    assert C.collective_bytes("all-reduce", nb, 4) == pytest.approx(
        2 * nb * 3 / 4)
    assert C.collective_bytes("reduce-scatter", nb, 4) == pytest.approx(
        nb * 4 * 3 / 4)
    assert C.collective_bytes("all-to-all", nb, 4) == pytest.approx(
        nb * 3 / 4)
    cp = H.Instr("cp", "bf16[64]{0}", "collective-permute",
                 "  %cp = bf16[64]{0} collective-permute(%x), "
                 "source_target_pairs={{0,1},{1,0}}")
    assert C.collective_bytes("send", 64 * 2, 2) == pytest.approx(
        H._collective_bytes(cp)) == 128
    assert C.collective_bytes("recv", 64 * 2, 2) == 0
    assert C.collective_bytes("all-gather", nb, 1) == 0


def test_dtype_bytes_match_jax_table():
    pairs = {"f32": torch.float32, "bf16": torch.bfloat16,
             "f16": torch.float16, "s32": torch.int32, "s64": torch.int64,
             "s8": torch.int8, "u8": torch.uint8, "pred": torch.bool,
             "f64": torch.float64, "f8e4m3fn": torch.float8_e4m3fn}
    for name, dt in pairs.items():
        assert C.dtype_bytes(dt) == H._DTYPE_BYTES[name], name


def test_roofline_terms_at_h100_constants():
    c = C.Costs(flops=989e12, hbm_bytes=3.35e12, coll_bytes=450e9,
                coll_bytes_by_link={"nvlink": 450e9})
    t = C.roofline_terms(c, model_flops_global=989e12 * 256, n_chips=256)
    for k in ("t_compute_s", "t_memory_s", "t_collective_s",
              "roofline_fraction", "useful_flops_ratio"):
        assert t[k] == pytest.approx(1.0), k
    want = H.roofline_terms(H.Costs(flops=1.0, hbm_bytes=1.0, coll_bytes=1.0),
                            model_flops_global=1.0, n_chips=1)
    assert set(want) <= set(t)
    net = C.roofline_terms(C.Costs(coll_bytes=50e9,
                                   coll_bytes_by_link={"network": 50e9}))
    assert net["t_collective_s"] == pytest.approx(1.0)
    assert net["dominant"] == "collective"
    assert net["link_rates"] == {"network": 50e9}
    assert C.link_of(range(8)) == "nvlink"
    assert C.link_of(range(16)) == "network"
    assert C.link_of([3, 11]) == "network"


def test_counter_views_and_memory():
    """An op reads its operands and writes its result, a view and an
    allocation move nothing, and live memory follows the storages."""
    with C.CostCounter(fake=False) as cc:
        a = torch.empty(1000)            # 4000 bytes, not written
        b = a * 2                        # 4000 more
        v = b[10:]                       # a view: free
        del a
    assert cc.n_ops == 3                 # empty, mul, the view
    assert cc.costs.flops == 1000
    assert cc.costs.hbm_bytes == 8000
    assert cc.peak_bytes == 8000
    assert cc.memory()["output_size_in_bytes"] == 4000
    del b, v


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b",
                                  "xlstm-350m"])
def test_fake_trace_equals_real_step(arch):
    """The dry run's fidelity on the CPU: a reduced one-pod step traced
    under fake tensors and run for real count the same FLOPs, bytes,
    ops and collectives, and hold the same peak of live memory."""
    cfg = get_config(arch, reduced=True)
    res = fake_and_real(cfg, ShapeSpec("t", 32, 2, "train"), device="cpu")
    fake, real = res["fake"], res["real"]
    assert fake.costs.flops == real.costs.flops > 0
    assert fake.costs.hbm_bytes == real.costs.hbm_bytes > 0
    assert fake.n_ops == real.n_ops
    assert fake.op_counts == real.op_counts
    assert fake.costs.coll_counts == real.costs.coll_counts
    assert fake.peak_bytes == real.peak_bytes
    assert fake.final_memory == real.final_memory
    assert fake.final_memory["argument_size_in_bytes"] > 0


FAKE_WORLD = r'''
import json, math
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import mesh as M
from repro_torch.launch.cost_analysis import CostCounter
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.specs import cell_specs
from repro_torch.configs import get_config
from repro_torch.sharding.api import axis_sizes
from repro_torch.tree import flatten

out = {}
with M.fake_world(512):
    mesh = M.make_production_mesh(multi_pod=True)
    tm = mesh.dtensor_mesh["model"]
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(8, 512, 4096, dtype=torch.bfloat16),
                               tm, [Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(4096, 1024, dtype=torch.bfloat16),
                               tm, [Shard(1)], run_check=False)
        reps = []
        for _ in range(2):
            with CostCounter(fake=True) as cc:
                y = (x @ w).redistribute(tm, [Replicate()])
            reps.append([cc.costs.flops, cc.costs.coll_counts,
                         cc.costs.coll_bytes, list(y.shape)])
            del y
        out["product"] = reps
        g4 = mesh.groups["model"]
        sub = dist.new_group([0, 1, 2, 3])
        with CostCounter(fake=True) as cc:
            inp = torch.empty(2, 128)
            got = torch.empty(8, 128)
            dist.all_gather_into_tensor(got, inp, group=sub)
            dist.send(torch.empty(64, dtype=torch.bfloat16), 1)
        out["coll"] = [cc.costs.coll_bytes, cc.costs.coll_counts]
    out["groups_inside"] = len(M._GROUPS)
out["after"] = [dist.is_initialized(), len(M._GROUPS)]

cfg = get_config("gemma2-2b", reduced=True)
shape = ShapeSpec("t", 64, 8, "train")
rec = run_cell("gemma2-2b", "train_4k", True, shape=shape, reduced=True,
               mesh_shape=(2, 2, 2), device="cpu", verbose=False)
out["cell"] = rec

# what the placements give a rank: the local shards of the parameters
# and optimizer state (master, m, v in f32, the step counter), the
# batch, the FedAvg weights and mask
class Mesh:
    axis_names = ("pod", "data", "model")
    def __init__(self):
        import numpy as np
        self.devices = np.empty((2, 2, 2))
sizes = {"pod": 2, "data": 2, "model": 2}
sp = cell_specs(cfg, shape, Mesh())
from repro_torch.launch.specs import _meta_params
from repro_torch.sharding.api import _spec_leaves
leaves = flatten(_meta_params(cfg))[0]
want = 0
for leaf, spec in zip(leaves, _spec_leaves(sp["pspecs"])):
    split = 1
    for entry in spec:
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            split *= sizes.get(a, 1)
    n = leaf.numel() // split
    want += n * leaf.element_size() + 3 * n * 4
want += 4                                   # the step counter
want += 2 * (2 * 4 * 64 * 8)                # inputs + labels, int64
want += 2 * (2 * 4)                         # weights, active
out["want_arg_bytes"] = want
print("RESULT " + json.dumps(out))
'''


@pytest.fixture(scope="module")
def fake_world_run(tmp_path_factory):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(FAKE_WORLD)],
                          env=env, capture_output=True, text=True,
                          timeout=300, cwd=str(tmp_path_factory.mktemp("fw")))
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def test_per_rank_flops_of_a_sharded_product(fake_world_run):
    """(8, 512, 4096) @ (4096, 16384) in bf16, the weight split over a
    16-rank ``model`` group of a 512-rank world: this rank multiplies
    its (4096, 1024) shard, 2 x 8 x 512 x 4096 x 1024 = 34.36e9 FLOPs
    (not DTensor's logical 549.8e9, nor 584.1e9 with its sharding
    propagation), and one all-gather; the same on a repeat, when the
    propagation is cached."""
    first, again = fake_world_run["product"]
    assert first[0] == 2 * 8 * 512 * 4096 * 1024 == pytest.approx(34.36e9,
                                                                  rel=1e-3)
    assert first[1] == {"all-gather": 1}
    # (p - 1) / p of the gathered (8, 512, 16384) bf16 result
    assert first[2] == pytest.approx(8 * 512 * 16384 * 2 * 15 / 16)
    assert first[3] == [8, 512, 16384]
    assert again == first


def test_counted_collectives_use_ring_factors(fake_world_run):
    coll_bytes, counts = fake_world_run["coll"]
    assert counts == {"all-gather": 1, "send": 1}
    assert coll_bytes == pytest.approx(8 * 128 * 4 * 3 / 4 + 64 * 2)


def test_fake_world_leaves_no_groups(fake_world_run):
    assert fake_world_run["groups_inside"] > 0
    assert fake_world_run["after"] == [False, 0]


def test_reduced_gemma2_train_cell(fake_world_run):
    """The counterpart of ``tests/test_dist_multidevice.py:152``: reduced
    gemma2-2b's training cell on a fake (2, 2, 2) mesh traces, costs
    FLOPs and collective bytes, and holds as arguments exactly the
    local shards its placements give."""
    rec = fake_world_run["cell"]
    assert rec["status"] == "ok"
    assert rec["cost"]["flops"] > 0 and rec["cost"]["coll_bytes"] > 0
    assert rec["cost"]["coll_counts"].get("send", 0) > 0   # the pod ring
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == fake_world_run["want_arg_bytes"]
    assert mem["total_per_device_bytes"] >= mem["argument_size_in_bytes"]
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
