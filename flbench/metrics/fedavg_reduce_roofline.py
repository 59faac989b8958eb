"""``fedavg_reduce`` (``csrc/fedavg.cu``) over the traced rounds: the
bytes its calls need (updates read once, the aggregate written once,
from their shapes) over the HBM rate, as a share of the kernel's device
time."""
from harness.peaks import HBM_BYTES_PER_S, fedavg_reduce_bytes

CALLS = [("repro_torch.dist.torrent", "fedavg_reduce")]
KERNELS = ("fedavg_reduce_kernel",)


def read(run):
    calls = run.calls.get("repro_torch.dist.torrent:fedavg_reduce", [])
    dev = sum(run.trace.get("kernels", {}).get(k, 0.0) for k in KERNELS)
    if not calls or dev <= 0:
        return None
    need = sum(fedavg_reduce_bytes(*c[0][0], c[0][1]) for c in calls)
    return 100.0 * need / HBM_BYTES_PER_S / dev
