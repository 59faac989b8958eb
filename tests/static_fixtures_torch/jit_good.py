"""Known-good torch host-sync fixture: the same shapes, graph-capture
safe — masked selects, bounded loops, nothing read back."""
import torch


def maxmin_rates(rem, rates, n_passes: int = 8):
    for _ in range(n_passes):               # bounded, data-independent
        mask = rem > 0
        rates = torch.where(mask, rates + 1, rates)
        rem = torch.where(mask, rem - 1, rem)
    return rates


def transport(rem, rates, max_steps: int = 64):
    total = torch.zeros((), dtype=rem.dtype)
    for _ in range(max_steps):              # bounded loop with masking
        alive = rem > 0
        step = torch.where(alive, rem, torch.inf).amin()
        step = torch.where(torch.isfinite(step), step, 0.0)
        rem = rem - step * alive
        total = total + step
    # three-argument where is an elementwise select, not an index set
    for row in torch.where(rem[None] > 0, rates[None], 0.0):
        total = total + row.sum()
    return total
