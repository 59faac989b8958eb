"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

    python3 flbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` once, from the root of a checkout,
on the GPUs of the machine it starts on, and prints one JSON line last
on standard output: ``correct``, ``attempted`` and ``failed`` (rounds),
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each number that decided ``correct`` beside its limit
(also the last lines on standard error).

It refuses to run (exit 2, no result) without as many CUDA devices as
the cell asks for, and fails (exit 1, no result) when the JAX package,
``jax``, ``jaxlib`` or ``flax`` is loaded once the window has closed.
The program's kernels build into ``build/`` inside the checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "repro")


def loaded_banned() -> list[str]:
    """Loaded modules whose top-level name is banned (compared whole)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in BANNED})


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def setup_paths() -> None:
    """The harness's own modules, then the program's package (whose
    kernels build into ``build/torch_kernels`` in the checkout)."""
    for p in (str(HERE), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None, *, device=None, t_start: float = T_START) -> dict:
    """Run a cell; returns the result.  ``device`` (tests only) runs it on
    that device without looking for GPUs."""
    args = parse(argv)
    setup_paths()
    import torch
    from harness import cell as cell_mod
    from harness.spec import load_cell, metric_module

    cell = load_cell(args.workload, ROOT)
    if device is None:
        have = (torch.cuda.device_count() if torch.cuda.is_available()
                 else 0)
        if have < cell.chips:
            print(f"{args.workload} needs {cell.chips} CUDA device(s), "
                  f"found {have}", file=sys.stderr)
            raise SystemExit(2)
        if cell.chips != 1:
            raise SystemExit(f"{args.workload}: a cell on {cell.chips} "
                             "chips has no driver in this harness")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)
    readers = {m["name"]: metric_module(m["name"], ROOT)
               for m in cell.end_to_end + cell.per_layer}
    return cell_mod.run_cell(cell, seed=args.seed, seconds=args.seconds,
                             trace=bool(args.trace), device=device,
                             t_start=t_start, readers=readers)


def report(result: dict) -> None:
    """The check's numbers last on stderr, the result last on stdout."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    res = main()
    bad = loaded_banned()
    if bad:
        print(f"the JAX package or JAX is loaded: {bad}", file=sys.stderr)
        raise SystemExit(1)
    report(res)
