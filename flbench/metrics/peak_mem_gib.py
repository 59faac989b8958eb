"""``torch.cuda.max_memory_allocated`` over set-up and window, read
before the reference runs: what the round needs to fit."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
