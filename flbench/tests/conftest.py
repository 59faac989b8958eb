"""Fixtures of the benchmark's tests: its modules on the path, and a copy
of the benchmark with tiny cells that a CPU runs in seconds."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# the tiny cells stand for the real ones: the same layer kinds, dtypes
# and traffic, every width cut
TINY_ARCH = dict(n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
                 vocab=509, n_experts=8, top_k=2, d_expert=32)
TINY = {"tiny.int8": ("granite-moe-1b-a400m", True),
        "tiny.f32": ("olmoe-1b-7b-l4", False)}
# Limits of their own, set as the real cells' are: between the most the
# program read over 12 seeds (2**31 + 0..11; both cells: loss 5.05e-4,
# pod grad 1.04e-2, grad 4.3e-3, change 2.63e-3) and the least a fault
# read on 3 seeds (half_batch: loss 7.31e-3, pod grad 0.446;
# no_exchange: grad 0.161; f32 half_batch: change 1.93e-2).  At this
# size the fp8 control reads 1.5x to 1.7x the program, no more, so it
# is held to the real cells' limits on the card instead.
TINY_LIMITS = {"loss_gap": 2e-3, "pod_grad_gap": 0.05,
               "grad_norm_gap": 0.03, "change_norm_gap": 0.01}


def add_tiny_cells(root: Path) -> None:
    """Add the tiny configurations, mixes, limits and cells to the
    benchmark under ``root``, as new files and entries."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for name, (conf, compress) in TINY.items():
        c = json.loads((root / "flbench" / "configs" / f"{conf}.json")
                       .read_text())
        c["arch"].update(TINY_ARCH)
        (root / "flbench" / "configs" / f"{name}.json").write_text(
            json.dumps(c))
        t = json.loads((root / "flbench" / "traffic" /
                        "fl-round.p2.b4x4096.int8.json").read_text())
        t.update(rows_per_pod=4, seq=64, compress=compress)
        (root / "flbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(t))
        (root / "flbench" / "limits" / f"{name}.json").write_text(
            json.dumps(TINY_LIMITS))
        spec["configs"].append({"name": name, "source": "test",
                                "file": f"flbench/configs/{name}.json",
                                "reduced": [], "why": "test"})
        spec["workloads"].append({"name": name, "config": name,
                                  "traffic": name, "chips": 1,
                                  "why": "test"})
    for m in spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.int8")
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))


def copy_bench(dest: Path, with_src: bool = True) -> Path:
    """BENCHMARK.json and flbench/ copied to ``dest`` (the program's
    sources linked in when ``with_src``)."""
    shutil.copytree(BENCH, dest / "flbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    if with_src:
        (dest / "src").symlink_to(ROOT / "src")
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    root = copy_bench(tmp_path)
    add_tiny_cells(root)
    return root


def run_cpu(root: Path, workload: str, *, seed: int = 2 ** 31 + 5,
            seconds: float = 0.5, trace: int = 0) -> dict:
    """One run of ``workload`` of the benchmark under ``root`` on the
    CPU, through ``run.main``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "flbench_run_copy", root / "flbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(["--workload", workload, "--seed", str(seed),
                     "--seconds", str(seconds), "--trace", str(trace)],
                    device="cpu")
