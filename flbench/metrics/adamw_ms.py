"""Stream milliseconds a round of the AdamW update (``optim/adamw.py``
as ``dist/fl_step`` calls it); the mean over the window's rounds."""
import statistics

SPANS = {"adamw": [("repro_torch.dist.fl_step", "adamw_update")]}


def read(run):
    ms = run.span_ms.get("adamw")
    return statistics.fmean(ms) if ms else None
