"""Readings that set a cell's limits: the program's, the control's and
the planted faults', each against the reference, at the cell's size.

    python3 flbench/control.py --workload <cell> --seeds 11,12,... \
        [--control-seeds 11,12,13] [--fault-seeds 11,12,13] \
        [--faults half_batch,no_exchange,answer_altered] [--out FILE]

For each seed it builds the program from the seed, drives the first
rounds as a benchmark run's set-up does, and compares them with the
reference's (``harness/check.py``); on the control seeds it also
compares the reference computed with fp8 operands (the control: the
precision below the configuration's bfloat16), and on the fault seeds
the program with each fault of ``faults.py`` planted.  One JSON line a
reading, on stdout and in ``--out``.  The benchmark's runs do not run
this; it needs the cell's GPUs.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _ints(s: str) -> list[int]:
    return [int(x) for x in s.split(",") if x]


def readings(cell, seeds, control_seeds, fault_seeds, faults, device,
             emit) -> None:
    import faults as fault_mod
    from harness import cell as cell_mod
    from harness import check

    for seed in seeds:
        found, took = {}, {}
        kinds = [None] + (faults if seed in fault_seeds else [])
        for kind in kinds:
            t = time.perf_counter()
            with fault_mod.planted(kind):
                prog = cell_mod.Program(cell, seed, device)
                found[kind], _ = prog.first_rounds()
                del prog
            cell_mod.free(device)
            took[kind] = time.perf_counter() - t
        if seed in control_seeds:
            t = time.perf_counter()
            found["control"] = cell_mod.reference_readings(
                cell, seed, device, precision="fp8")
            cell_mod.free(device)
            took["control"] = time.perf_counter() - t
        t = time.perf_counter()
        ref = cell_mod.reference_readings(cell, seed, device)
        cell_mod.free(device)
        took["reference"] = time.perf_counter() - t
        for kind, got in found.items():
            g = check.gaps(got, ref)
            emit({"cell": cell.name, "seed": seed,
                  "side": kind or "program",
                  **{k: v[0] for k, v in g.items()},
                  "at": {k: v[1] for k, v in g.items()},
                  "loss": got["loss"], "ref_loss": ref["loss"],
                  "leaf_gaps": _leaf_gaps(got, ref),
                  "seconds": took[kind], "ref_seconds": took["reference"]})


def _leaf_gaps(got: dict, ref: dict) -> dict:
    """Each leaf's gap of norms (the look behind a worst leaf)."""
    def gap(g, r):
        return [abs(a - b) / max(b, 1e-30) for a, b in zip(g, r)]
    return {"pod_grad": [gap(g, r) for g, r in zip(got["pod_grad_norm"],
                                                   ref["pod_grad_norm"])],
            "grad": gap(got["grad_norm"], ref["grad_norm"]),
            "change": gap(got["change_norm"], ref["change_norm"])}


def main(argv=None, *, device=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--faults", default="half_batch,no_exchange,"
                    "answer_altered")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    import run
    run.setup_paths()
    import torch
    from harness.spec import load_cell

    cell = load_cell(args.workload, ROOT)
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("control.py needs a CUDA device")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    try:
        readings(cell, args.seeds, args.control_seeds, args.fault_seeds,
                 [f for f in args.faults.split(",") if f], device, emit)
    finally:
        if out:
            out.close()


if __name__ == "__main__":
    main()
