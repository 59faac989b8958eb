"""The share of the traced rounds' wall time in which no kernel, copy
or fill ran on the device (``torch.profiler``)."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
