"""``chunk_dequantize`` (``csrc/quantize.cu``) over the traced rounds:
the bytes its calls need (int8 codes and scales read once, the values
written once) over the HBM rate, as a share of the kernel's device
time."""
from harness.peaks import HBM_BYTES_PER_S, chunk_dequantize_bytes

CALLS = [("repro_torch.dist.torrent", "chunk_dequantize")]
KERNELS = ("dequantize_kernel",)


def read(run):
    calls = run.calls.get("repro_torch.dist.torrent:chunk_dequantize", [])
    dev = sum(run.trace.get("kernels", {}).get(k, 0.0) for k in KERNELS)
    if not calls or dev <= 0:
        return None
    # arguments: the codes (n, E), the scales, and the output (n, E)
    need = sum(chunk_dequantize_bytes(*c[0][0], c[-1][1]) for c in calls)
    return 100.0 * need / HBM_BYTES_PER_S / dev
