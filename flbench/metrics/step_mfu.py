"""Model FLOPs of the window's rounds (6 N_active tokens plus the
attention products, ``harness/flops.py``) over the window's wall time,
as a share of the cell's chips' bf16 peak."""
from harness.peaks import BF16_FLOPS


def read(run):
    if run.rounds == 0 or run.window_s <= 0:
        return None
    rate = run.flops_per_round * run.rounds / run.window_s
    return 100.0 * rate / (BF16_FLOPS * run.chips)
