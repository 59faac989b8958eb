"""Stream milliseconds a round of every pod's forward and backward
(``models.train_loss`` through ``dist/fl_step``'s gradient call), the
pods' calls summed; the mean over the window's rounds."""
import statistics

SPANS = {"grad": [("repro_torch.dist.fl_step",
                   "_microbatched_value_and_grad")]}


def read(run):
    ms = run.span_ms.get("grad")
    return statistics.fmean(ms) if ms else None
