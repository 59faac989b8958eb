"""``chunk_quantize`` (``csrc/quantize.cu``: its amax, scale and code
kernels) over the traced rounds: the bytes its calls need (f32 blocks
read once, int8 codes and scales written once) over the HBM rate, as a
share of the kernels' device time."""
from harness.peaks import HBM_BYTES_PER_S, chunk_quantize_bytes

CALLS = [("repro_torch.dist.torrent", "chunk_quantize")]
KERNELS = ("amax_partial_kernel", "row_scale_kernel", "quantize_kernel")


def read(run):
    calls = run.calls.get("repro_torch.dist.torrent:chunk_quantize", [])
    dev = sum(run.trace.get("kernels", {}).get(k, 0.0) for k in KERNELS)
    if not calls or dev <= 0:
        return None
    need = sum(chunk_quantize_bytes(*c[0][0]) for c in calls)
    return 100.0 * need / HBM_BYTES_PER_S / dev
