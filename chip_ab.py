#!/usr/bin/env python3
"""Time the port's main path in two checkouts on one card, interleaved.

    python3 chip_ab.py --roots build/ab_parent . . build/ab_parent
    python3 chip_ab.py --phases train --roots A B B A A B B A A B

Each ``--roots`` entry is the root of a checkout (one holding
``chip_smoke.py`` and ``src/repro_torch``); give the two trees as A, B,
B, A so that a drift of the card or the host over the call falls on
both.  Every checkout's CUDA extension is built first, all at once, in
a process of its own.  Then, one run after another, a fresh process
loads that checkout's ``chip_smoke.py`` and drives the phases that
``--phases`` names (all three by default) with that checkout's own
functions:

    train   ``run_train_path`` of each of ``TRAIN_PATHS`` (the train
            driver's steps, then the compressed ``ElasticFLStep``'s)
    serve   ``run_serving_path`` (each serving arch's prefill and
            decode at full width)
    fl      ``run_fl_paths`` (Table II's rows, churn, async)

Every run's step seconds, prefill seconds, decode rate and phase
seconds are parsed from what those functions log; a line of them
follows each run, and one JSON object of all runs, with the card's
name and power limit, is the last line of the output.  Needs one
card; exits 1 if a run fails.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

RUN_TIMEOUT = 900.0              # seconds a build or a run may take

BUILD = r'''
import sys, time
sys.path.insert(0, sys.argv[1] + "/src")
from repro_torch.kernels import _build
t0 = time.perf_counter()
_build.extension()
print(f"built {sys.argv[1]} in {time.perf_counter() - t0:.1f} s", flush=True)
'''

RUN = r'''
import importlib.util, json, re, sys, time
root, phases = sys.argv[1], sys.argv[2].split(",")
spec = importlib.util.spec_from_file_location("chip_smoke_ab",
                                              root + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
lines = []
say = cs.log


def log(msg):
    lines.append(str(msg))
    say(msg)


cs.log = log
cs.setup()
from repro_torch.kernels import _build
_build.extension()
res = {"root": root, "phase_s": {}}
if "train" in phases:
    t0 = time.perf_counter()
    for arch, d, steps, comp in cs.TRAIN_PATHS:
        cs.run_train_path(arch, d, steps, comp)
    res["phase_s"]["train"] = time.perf_counter() - t0
if "serve" in phases:
    t0 = time.perf_counter()
    cs.run_serving_path()
    res["phase_s"]["serve"] = time.perf_counter() - t0
if "fl" in phases:
    res["phase_s"]["fl"] = cs.run_fl_paths()["phase_s"]
num = r"[0-9.]+"
for ln in lines:
    m = re.match(r"(\S+) train driver: .*; step s ([0-9., ]+);", ln)
    if m:
        res.setdefault("train_step_s", {})[m[1]] = [
            float(x) for x in m[2].split(", ")]
    m = re.match(r"(\S+) compressed ElasticFLStep: .*; step s ([0-9., ]+);",
                 ln)
    if m:
        res.setdefault("compressed_step_s", {})[m[1]] = [
            float(x) for x in m[2].split(", ")]
    m = re.match(rf"serve (\S+) full width.*: prefill ({num}) s, decode "
                 rf"({num}) tok/s", ln)
    if m:
        res.setdefault("prefill_s", {})[m[1]] = float(m[2])
        res.setdefault("decode_tok_s", {})[m[1]] = float(m[3])
print("AB " + json.dumps(res), flush=True)
'''


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def table(runs) -> list[str]:
    rows = []
    for r in runs:
        cells = [r["root"]]
        cells += [f"{k} {v:.1f} s" for k, v in r["phase_s"].items()]
        for arch, ts in r.get("train_step_s", {}).items():
            # the first step is a warm-up (allocator, cuBLAS handles)
            cells.append(f"{arch} step {_median(ts[1:]):.3f} s")
        for arch, t in r.get("prefill_s", {}).items():
            cells.append(f"{arch} prefill {t:.3f} s")
        rows.append(" | ".join(cells))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", nargs="+", required=True)
    ap.add_argument("--phases", default="train,serve,fl",
                    help="comma-separated: train, serve, fl")
    args = ap.parse_args(argv)
    if not set(args.phases.split(",")) <= {"train", "serve", "fl"}:
        raise SystemExit(f"unknown phase in {args.phases!r}")
    roots = [str(Path(r).resolve()) for r in args.roots]
    for r in roots:
        if not (Path(r) / "chip_smoke.py").is_file():
            raise SystemExit(f"{r} holds no chip_smoke.py")
    card = card_line()
    print(card, flush=True)
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    t0 = time.perf_counter()
    builds = [subprocess.Popen([sys.executable, "-c", BUILD, r], env=env)
              for r in dict.fromkeys(roots)]
    if any(p.wait(timeout=RUN_TIMEOUT) != 0 for p in builds):
        print("a build failed", file=sys.stderr, flush=True)
        return 1
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)
    runs = []
    for r in roots:
        proc = subprocess.run([sys.executable, "-c", RUN, r, args.phases],
                              env=env, capture_output=True, text=True,
                              timeout=RUN_TIMEOUT)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n",
                  file=sys.stderr, flush=True)
            return 1
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("AB ")][-1]
        runs.append(json.loads(line[3:]))
        print(table(runs[-1:])[0], flush=True)
    print(json.dumps({"card": card, "phases": args.phases, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
