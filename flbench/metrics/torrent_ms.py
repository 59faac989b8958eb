"""Stream milliseconds a round of the torrent: the int8 round trip
where the cell compresses, the ring's stages on a pod mesh, and the
masked FedAvg (``aggregate_blocks`` or ``ring_fedavg`` as
``dist/fl_step`` calls them); the mean over the window's rounds."""
import statistics

SPANS = {"torrent": [("repro_torch.dist.fl_step", "aggregate_blocks"),
                     ("repro_torch.dist.fl_step", "ring_fedavg")]}


def read(run):
    ms = run.span_ms.get("torrent")
    return statistics.fmean(ms) if ms else None
