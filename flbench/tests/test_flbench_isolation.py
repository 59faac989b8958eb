"""What the benchmark loads: nothing of the JAX package or JAX (top-level
names compared whole: ``repro_torch`` is not ``repro``), and a reference
that loads nothing of the program."""
from __future__ import annotations

import json
import subprocess
import sys

from conftest import BENCH, ROOT

BANNED = {"jax", "jaxlib", "flax", "repro"}

DRIVE = """
import json, sys
sys.path.insert(0, {bench!r})
import conftest
root = conftest.copy_bench(__import__("pathlib").Path({tmp!r}))
conftest.add_tiny_cells(root)
res = conftest.run_cpu(root, "tiny.int8", trace=1)
import faults, control, reference.model, reference.fl_round
print(json.dumps({{"correct": res["correct"], "modules": sorted(sys.modules)}}))
"""


def _loaded(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    got = _loaded(DRIVE.format(bench=str(BENCH / "tests"),
                               tmp=str(tmp_path)))
    assert got["correct"]
    tops = {m.split(".")[0] for m in got["modules"]}
    assert "repro_torch" in tops
    assert not tops & BANNED, sorted(tops & BANNED)


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import json, sys; sys.path.insert(0, {str(BENCH)!r}); "
            "import reference.model, reference.fl_round; "
            "print(json.dumps({'modules': sorted(sys.modules)}))")
    tops = {m.split(".")[0] for m in _loaded(code)["modules"]}
    assert not tops & (BANNED | {"repro_torch", "harness"})


def test_run_refuses_without_a_gpu():
    """Here, with no CUDA device: exit 2 and no result line."""
    out = subprocess.run(
        [sys.executable, "flbench/run.py", "--workload",
         "granite-1b.fl-round.p2.int8", "--seed", "4294967311",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    import torch
    if torch.cuda.is_available():
        return
    assert out.returncode == 2
    assert out.stdout.strip() == ""


def test_nothing_reads_the_old_benchmarks_folder():
    for path in BENCH.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and "import benchmarks" not in text, \
            path
        for line in text.splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in BANNED, (path, line)
