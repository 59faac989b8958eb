"""swarmlint CLI — ``python -m repro_torch.analysis [opts] [paths]``.

Runs every registered rule over the given paths (default:
``src/repro_torch``), subtracts the port's justified baseline
(``analysis_baseline_torch.json``; the JAX package's
``analysis_baseline.json`` names ``src/repro/`` paths and is never read
or written here), prints the host-sync readiness scorecard, and exits
non-zero on any non-baselined finding.  Pure stdlib: it runs where
there is no numpy, torch or jax.

Exit codes: 0 clean (or fully baselined), 1 new findings, 2 usage /
parse / baseline errors.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .findings import Baseline, split_by_baseline, write_baseline
from .jit_rules import scorecard
from .registry import FAMILIES, AnalysisContext, get_rules, rule_ids

DEFAULT_BASELINE = "analysis_baseline_torch.json"
DEFAULT_PATHS = ["src/repro_torch"]


def collect_findings(ctx, families=None) -> list:
    found = []
    for rule in get_rules(families):
        found.extend(rule.check(ctx))
    found.sort(key=lambda f: (f.path, f.line, f.rule, f.detail))
    return found


def print_scorecard(rows, out):
    print("\njit-readiness scorecard (host syncs and graph-capture "
          "hazards left in the hot paths):", file=out)
    for path, qual, counts, ready in rows:
        if ready:
            status = "READY"
        else:
            status = ", ".join(f"{r}x{n}"
                               for r, n in sorted(counts.items()))
        print(f"  {path}::{qual:34s} {status}", file=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="swarmlint for the port: rng-discipline, "
                    "visibility-escape, host-sync readiness and "
                    "telemetry static analysis")
    ap.add_argument("paths", nargs="*", default=DEFAULT_PATHS,
                    help="files/directories to analyze (default: "
                         f"{' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--baseline", default=None,
                    help=f"justified-baseline JSON (default: "
                         f"./{DEFAULT_BASELINE} when present)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline file")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to cover current "
                         "findings (keeps existing justifications; new "
                         "entries get 'TODO: justify')")
    ap.add_argument("--families", default=None,
                    help=f"comma list from {','.join(FAMILIES)} "
                         f"(default: all)")
    ap.add_argument("--assume-library", action="store_true",
                    help="treat every analyzed file as library + "
                         "sim-layer code (rule fixtures)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in get_rules():
            print(f"{rule.rule}  [{rule.family:10s}] "
                  f"{rule.severity:7s} {rule.title}")
        return 0

    families = None
    if args.families:
        families = tuple(args.families.split(","))
        bad = set(families) - set(FAMILIES)
        if bad:
            print(f"unknown families: {sorted(bad)}", file=sys.stderr)
            return 2

    ctx = AnalysisContext(Path.cwd(), assume_library=args.assume_library)
    try:
        ctx.add_paths(args.paths)
    except OSError as e:
        print(f"cannot read inputs: {e}", file=sys.stderr)
        return 2
    if ctx.errors:
        for err in ctx.errors:
            print(err, file=sys.stderr)
        return 2
    if not ctx.modules:
        print("no python files found under: "
              f"{' '.join(args.paths)}", file=sys.stderr)
        return 2

    findings = collect_findings(ctx, families)

    baseline = None
    bl_path = args.baseline or DEFAULT_BASELINE
    if not args.no_baseline and Path(bl_path).exists():
        try:
            baseline = Baseline.load(bl_path)
        except (ValueError, OSError) as e:
            print(f"bad baseline: {e}", file=sys.stderr)
            return 2
    elif args.baseline and not args.update_baseline:
        print(f"baseline {args.baseline} not found", file=sys.stderr)
        return 2

    if args.update_baseline:
        write_baseline(bl_path, findings, baseline)
        print(f"wrote {bl_path} covering {len(findings)} finding(s); "
              f"fill in any 'TODO: justify' entries")
        return 0

    new, baselined = split_by_baseline(findings, baseline)
    for f in new:
        print(f.render())

    rows = scorecard(ctx, findings)
    if rows and (families is None or "jit" in families):
        print_scorecard(rows, sys.stdout)

    stale = baseline.unused(findings) if baseline else []
    if stale:
        print(f"\nnote: {len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'} (no longer "
              f"firing) — prune with --update-baseline:")
        for k in stale:
            print(f"  {k}")

    print(f"\n{len(ctx.modules)} files, {len(rule_ids())} rules: "
          f"{len(new)} new finding(s), {len(baselined)} baselined")
    return 1 if new else 0
