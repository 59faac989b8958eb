"""CLI: ``python -m repro_torch.obs <command> recording.jsonl``.

``report``    summarize a recording (phase breakdown, warm-up share,
              top-k slowest peers, staleness distribution).
``validate``  schema-check a recording; exit 1 on violations.
``perfetto``  convert a recording to chrome-tracing JSON for
              https://ui.perfetto.dev.
"""
from __future__ import annotations

import argparse
import json
import sys

from .export import read_jsonl, validate_rows, write_perfetto
from .report import format_report, summarize


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("report", help="summarize a JSONL recording")
    p.add_argument("path")
    p.add_argument("--top", type=int, default=5,
                   help="slowest peers to list (default 5)")
    p.add_argument("--json", action="store_true",
                   help="emit the summary as JSON instead of text")

    p = sub.add_parser("validate", help="schema-check a recording")
    p.add_argument("path")

    p = sub.add_parser("perfetto",
                       help="convert a recording to chrome-tracing JSON")
    p.add_argument("path")
    p.add_argument("out", help="output trace path (.json)")

    args = ap.parse_args(argv)
    rows = read_jsonl(args.path)
    if args.cmd == "validate":
        errs = validate_rows(rows)
        for e in errs:
            sys.stderr.write(e + "\n")
        sys.stdout.write(f"{len(rows)} rows, "
                         f"{len(errs)} violation(s)\n")
        return 1 if errs else 0
    if args.cmd == "perfetto":
        n = write_perfetto(rows, args.out)
        sys.stdout.write(f"wrote {n} trace events -> {args.out}\n")
        return 0
    summary = summarize(rows, top_k=args.top)
    if args.json:
        sys.stdout.write(json.dumps(summary, indent=2, default=str)
                         + "\n")
    else:
        sys.stdout.write(format_report(summary) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
