"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W power limit), and the bytes a kernel's call needs:
each input read once, each output written once, from the shapes."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 494e12
F32_FLOPS = 67e12


def fedavg_reduce_bytes(n: int, d: int, itemsize: int) -> int:
    """(n, D) updates read, (n,) weights and mask read, (D,) written."""
    return n * d * itemsize + 2 * n * 4 + d * itemsize


def chunk_quantize_bytes(n: int, e: int) -> int:
    """(n, E) f32 read, (n, E) int8 codes and (n,) f32 scales written."""
    return n * e * 4 + n * e + n * 4


def chunk_dequantize_bytes(n: int, e: int, out_itemsize: int) -> int:
    """(n, E) int8 codes and (n,) scales read, (n, E) values written."""
    return n * e + n * 4 + n * e * out_itemsize
