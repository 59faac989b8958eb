"""A cell, a configuration, a traffic mix and a metric are each new files
and entries: the harness finds them by name, no existing file edited."""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

import pytest

from conftest import add_tiny_cells, copy_bench, run_cpu

METRIC = '''"""Rounds in the window: a test's metric."""


def read(run):
    return float(run.rounds)
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "flbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_and_entries_make_a_new_cell(tmp_path):
    root = copy_bench(tmp_path)
    before = _digests(root)
    add_tiny_cells(root)
    (root / "flbench" / "metrics" / "dummy_rounds.py").write_text(METRIC)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "dummy_rounds", "unit": "rounds", "better": "higher",
        "source": "host_clock", "layer": "test", "moves":
        "train_tokens_per_s", "workloads": ["tiny.f32"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items()), \
        "an existing file of the benchmark changed"
    res = run_cpu(root, "tiny.f32", trace=1)
    assert res["correct"], res["checks"]
    assert res["metrics"]["dummy_rounds"]["value"] >= 1
    # a metric listed for other cells is not read in this one
    assert "chunk_quantize_roofline" not in res["metrics"]


def test_an_unknown_cell_is_refused(tmp_path):
    root = copy_bench(tmp_path)
    with pytest.raises(SystemExit):
        run_cpu(root, "no-such-cell")


def test_a_checkout_without_the_program_gives_no_result(tmp_path):
    """BENCHMARK.json and flbench/ alone: the run fails, no result."""
    root = copy_bench(tmp_path, with_src=False)
    add_tiny_cells(root)
    code = ("import sys; sys.path.insert(0, 'flbench'); import run; "
            "res = run.main(['--workload', 'tiny.int8', '--seed', '5', "
            "'--seconds', '0.5'], device='cpu'); run.report(res)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "ModuleNotFoundError" in out.stderr
    assert "correct" not in out.stdout
