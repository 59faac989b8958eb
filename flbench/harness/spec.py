"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is ``configs/<config>.json`` (the entry's
``file``), its traffic ``traffic/<traffic>.json``, its limits
``limits/<cell>.json``, and each metric ``metrics/<metric>.py``: a
later cell, configuration, mix or metric is a new file and a new entry.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file
    traffic: dict
    limits: dict
    end_to_end: list      # metric entries of BENCHMARK.json
    per_layer: list


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _for_cell(entries: list, cell: str) -> list:
    return [m for m in entries if "workloads" not in m
            or cell in m["workloads"]]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = load_spec(root)
    bench = root / "flbench"
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have "
                         f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(bench / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(bench / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    e2e = _for_cell(spec["end_to_end"], name)
    names = {m["name"] for m in e2e}
    layer = [m for m in _for_cell(spec["per_layer"], name)
             if "workloads" in m or m["moves"] in names]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, layer)


def metric_module(name: str, root: Path = ROOT):
    """The reader ``metrics/<name>.py``: ``read(run)`` gives the value or
    None where the run has nothing to read; optional ``SPANS`` (span
    name -> the program's (module, function) to time) and ``CALLS``
    ((module, function) whose calls' arguments the traced rounds keep)."""
    path = root / "flbench" / "metrics" / f"{name}.py"
    mod_name = "flbench_metric_" + name.replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
