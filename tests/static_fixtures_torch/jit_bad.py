"""Known-bad torch host-sync fixture: functions named like the hot-path
targets (the jit rules match on target names under
``--assume-library``) with torch's read-backs; each marked line fires
its rules."""
import torch


def maxmin_rates(rem, rates):
    if torch.any(rem > 0):                              # JIT101
        rates = rates + 1
    if bool(rem.sum() > 0):                             # JIT101 JIT102
        rates = rates * 2
    return rates


def transport(rem, rates):
    total = torch.zeros(())
    while torch.count_nonzero(rem) > 0:                 # JIT103
        step = rem.min().item()                         # JIT102
        rem = rem - step
    for i in torch.nonzero(rem):                        # JIT103
        total += rates[i]
    for i in rem.nonzero():                             # JIT103
        total += rates[i]
    for i in torch.argwhere(rem):                       # JIT103
        total += rates[i]
    for v in torch.unique(rem):                         # JIT103
        total += v
    for idx in torch.where(rem > 0):                    # JIT103
        total += rates[idx].sum()
    per_flow = rates.tolist()                           # JIT102
    host = rates.cpu()                                  # JIT102
    arr = host.numpy()                                  # JIT102
    return total, per_flow, arr
