"""The benchmark's frozen copies hold to the program's originals."""
from __future__ import annotations

import json

import numpy as np
import pytest

from harness import flops, traffic
from harness.spec import load_cell, load_spec

from conftest import ROOT

CELLS = [w["name"] for w in load_spec(ROOT)["workloads"]]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11])
def test_traffic_draws_the_programs_synthetic_batch(seed):
    from repro_torch.launch.train import synthetic_batch
    a = np.random.default_rng(seed)
    b = np.random.default_rng(seed)
    x, y = traffic.synthetic_batch(a, 2, 3, 17, 509)
    want = synthetic_batch(b, 2, 3, 17, 509)
    assert np.array_equal(x, want["inputs"].numpy())
    assert np.array_equal(y, want["labels"].numpy())


@pytest.mark.parametrize("name", CELLS)
def test_flops_equal_the_programs_model_flops(name):
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.flops import model_flops
    from harness.cell import arch_config
    cell = load_cell(name, ROOT)
    tr = cell.traffic
    b = tr["pods"] * tr["rows_per_pod"]
    want = model_flops(arch_config(cell.config["arch"]),
                       ShapeSpec("cell", tr["seq"], b, "train"))
    assert flops.train_flops(cell.config["arch"], b, tr["seq"]) == want


@pytest.mark.parametrize("name", CELLS)
def test_configs_count_the_programs_parameters(name):
    from repro_torch.models import init_params
    import torch
    from harness.cell import arch_config
    cfg = load_cell(name, ROOT).config
    meta = init_params(arch_config(cfg["arch"]), torch.Generator(),
                       device="meta")
    from reference.model import leaves
    n = sum(x.numel() for x in leaves(meta))
    assert flops.param_count(cfg["arch"]) == n
    if "params" in cfg:
        assert n == cfg["params"]
        assert flops.active_param_count(cfg["arch"]) == cfg["active_params"]


def test_benchmark_json_names_existing_files():
    spec = load_spec(ROOT)
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
        conf = json.loads((ROOT / c["file"]).read_text())
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
    for w in spec["workloads"]:
        assert (ROOT / "flbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "flbench" / "limits" / f"{w['name']}.json").is_file()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (ROOT / "flbench" / "metrics" / f"{m['name']}.py").is_file()
