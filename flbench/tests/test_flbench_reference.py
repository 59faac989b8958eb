"""The reference against the program: one ``ElasticFLStep`` round at the
configurations' REDUCED sizes (f32, so the two agree to rounding), int8
and f32 torrent alike; and the control and the faults caught at a tiny
size."""
from __future__ import annotations

import math

import pytest
import torch

from harness import cell as cell_mod
from harness import check
from harness.spec import load_cell, load_spec

from conftest import ROOT, run_cpu

CELLS = [w["name"] for w in load_spec(ROOT)["workloads"]]


def _reduced_cell(arch: str, compress: bool):
    from repro_torch.configs import get_config
    real = ("granite-1b.fl-round.p2.int8" if arch == "granite-moe-1b-a400m"
            else "olmoe-l4.fl-round.p2.f32")
    cell = load_cell(real, ROOT)
    cfg = get_config(arch, reduced=True)
    a = dict(cell.config["arch"])
    for k in ("n_layers", "d_model", "n_heads", "n_kv", "head_dim", "vocab",
              "n_experts", "top_k", "d_expert", "capacity_factor", "dtype",
              "remat"):
        a[k] = getattr(cfg, k)
    cell.config = dict(cell.config, arch=a)
    cell.traffic = dict(cell.traffic, rows_per_pod=2, seq=32,
                        compress=compress)
    return cell


@pytest.mark.parametrize("compress", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "olmoe-1b-7b"])
def test_reference_follows_the_program(arch, compress):
    cell = _reduced_cell(arch, compress)
    dev = torch.device("cpu")
    prog = cell_mod.Program(cell, 123, dev)
    got, _ = prog.first_rounds()
    want = cell_mod.reference_readings(cell, 123, dev)
    assert len(got["grad_norm"]) == len(want["grad_norm"])
    for name, (gap, _) in check.gaps(got, want).items():
        # f32 on both sides: what is left is the order of summation
        assert gap < 2e-4, (name, gap)
    # the rounds moved the loss and every leaf
    assert got["loss"][-1] != got["loss"][0]
    assert min(got["change_norm"]) > 0


def test_tiny_run_is_correct_and_reports_its_metrics(tiny_root):
    res = run_cpu(tiny_root, "tiny.int8", trace=0)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    # no peak memory on the CPU: its reader reads nothing there
    assert set(res["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert list(res)[-1] == "checks"
    traced = run_cpu(tiny_root, "tiny.int8", trace=1)
    for name in ("grad_ms", "torrent_ms", "adamw_ms", "step_mfu"):
        assert traced["metrics"][name]["value"] > 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "no_exchange", "answer_altered"])
def test_a_planted_fault_makes_the_run_incorrect(tiny_root, fault):
    import faults
    with faults.planted(fault):
        res = run_cpu(tiny_root, "tiny.int8")
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits(name):
    """At the cell's own size on the card: the reference computed as fp8
    training computes, in the program's place, is not correct by the
    cell's limits, on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is held to the "
                    "cells' limits at their own size")
    cell = load_cell(name, ROOT)
    dev = torch.device("cuda", 0)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        ref = cell_mod.reference_readings(cell, seed, dev)
        cell_mod.free(dev)
        ctl = cell_mod.reference_readings(cell, seed, dev, precision="fp8")
        cell_mod.free(dev)
        ok, checks = check.judge(check.gaps(ctl, ref), cell.limits)
        assert not ok, checks


def test_gaps_take_the_worst_leaf_against_the_median_floor():
    ref = {"loss": [10.0, 9.0], "grad_norm": [1.0, 2.0, 1e-6],
           "change_norm": [1.0, 2.0, 5.0],
           "pod_grad_norm": [[1.0, 2.0, 4.0], [1.0, 2.0, 4.0]]}
    prog = {"loss": [10.1, 9.0], "grad_norm": [1.1, 2.0, 0.5],
            "change_norm": [1.0, 2.0, 0.0],
            "pod_grad_norm": [[1.0, 2.0, 4.0], [1.0, 2.6, 4.0]]}
    g = check.gaps(prog, ref)
    assert g["loss_gap"] == (pytest.approx(0.01), 0)
    # leaf 2's tiny gradient is judged against the median leaf (1.0)
    assert g["grad_norm_gap"] == (pytest.approx(0.5 - 1e-6), 2)
    # leaf 2's gradient is nought to rounding: it is left out of the change
    assert g["change_norm_gap"][0] == 0.0
    assert g["change_median_gap"][0] == 0.0
    # pod 1's leaf 1 is 0.6 off, against its own norm, 2.0
    assert g["pod_grad_gap"] == (pytest.approx(0.3), 1)
    ok, _ = check.judge(g, {"loss_gap": 0.1, "grad_norm_gap": 0.1,
                            "change_norm_gap": 0.1, "pod_grad_gap": 1.0})
    assert not ok
    assert math.isinf(check.gaps(dict(prog, loss=[math.nan, 9.0]),
                                 ref)["loss_gap"][0])
