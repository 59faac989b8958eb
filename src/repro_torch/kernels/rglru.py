"""RG-LRU gated diagonal linear recurrence: CUDA wrapper.

    h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * (gx_t * x_t)

recurrentgemma's recurrent block (De et al., "Griffin", 2024).  The
kernels in ``csrc/rglru.cu`` replace the Pallas TPU kernel
``repro/kernels/rglru.py::rglru_scan``.  The function is bound by its
bytes (three inputs read, y written), so the aim is enough bytes in
flight to stream HBM.  ``route`` picks one of two kernels from T and
the dtype alone:

* ``"scan"`` (T of at least ``SCAN_MIN_CHUNKS`` chunks): a single-pass
  chunked scan.  One CTA per (b, chunk of ``SCAN_CHUNK`` rows, 128
  channels) loads its slabs once, runs a local pass in four
  sub-chunks side by side, publishes its aggregate, looks back over the
  chunks before it (decoupled look-back, tiles taken from an atomic
  ticket in chunk-major order) and rescans from shared memory.  It
  needs a scratch of flags and per-channel aggregates, which the
  wrapper allocates and the launcher zeroes (the flags) in the same
  call.  ``ref.rglru_chunked`` is the plain mirror of its association.
  Its bits may differ from run to run (a look-back finds a prefix or
  only an aggregate depending on timing), within 2e-5 of the loop;
* ``"seq"`` (short T, decode's T = 1 among them): one thread per (b, d)
  channel carries ``h`` in a register through a loop over T, and
  allocates no scratch.

Either way the wrapper counts one launch of ``rglru_scan`` per call.
For tensors on the CPU it runs the plain version (``ref.rglru``, a
sequential f32 loop); for CUDA tensors it launches its route's kernel
or raises.  Like the Pallas kernel it has no gradient:
``ops.rglru(impl="cuda")`` raises when one is asked for, and training
uses ``impl="torch"``.
"""
from __future__ import annotations

import torch

from . import _build, ref

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535
# The scan route's chunk (kChunk in csrc/rglru.cu) and threshold, from a
# sweep of both routes on one H100 at B 8, D 2560 (PERF.md): chunk 64
# was as fast as 128 at T = 8192 and faster at shorter T in bf16 and f32
# (three slabs of 64 x 128 channels: 48 KB of shared memory in bf16,
# 96 KB in f32), and the scan overtook the seq kernel between T = 128
# and 256 in both.
SCAN_CHUNK = 64
SCAN_MIN_CHUNKS = 4


def route(t: int, dtype: torch.dtype) -> str:
    """The kernel that serves T steps of ``dtype`` on the card:
    ``"scan"`` for f32 or bf16 with T at least ``SCAN_MIN_CHUNKS``
    chunks of ``SCAN_CHUNK``, else ``"seq"``."""
    if dtype in _DTYPES and t >= SCAN_MIN_CHUNKS * SCAN_CHUNK:
        return "scan"
    return "seq"


def rglru_scan(x: torch.Tensor, a: torch.Tensor, gate_x: torch.Tensor,
               h0: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """x, a, gate_x (B, T, D); h0 (B, D) f32 or None -> (y (B, T, D) in
    ``x.dtype``, h_T (B, D) f32)."""
    if _build.plain_route(x):
        return ref.rglru(x, a, gate_x, h0)
    _build.require_cuda("rglru_scan", x, a, gate_x,
                        *(() if h0 is None else (h0,)))
    if x.dim() != 3 or a.shape != x.shape or gate_x.shape != x.shape:
        raise ValueError(f"rglru_scan: x, a, gate_x must share one "
                         f"(B, T, D) shape, got {tuple(x.shape)}, "
                         f"{tuple(a.shape)}, {tuple(gate_x.shape)}")
    if x.dtype not in _DTYPES or a.dtype != x.dtype or gate_x.dtype != x.dtype:
        raise ValueError(f"rglru_scan: x, a, gate_x must share float32 or "
                         f"bfloat16, got {x.dtype}, {a.dtype}, "
                         f"{gate_x.dtype}")
    b, t, d = x.shape
    if h0 is not None:
        if h0.shape != (b, d) or h0.dtype != torch.float32:
            raise ValueError(f"rglru_scan: h0 must be ({b}, {d}) float32, "
                             f"got {tuple(h0.shape)} {h0.dtype}")
        h0 = h0.contiguous()
    x, a, gate_x = x.contiguous(), a.contiguous(), gate_x.contiguous()
    y = torch.empty_like(x)
    h_last = torch.empty((b, d), dtype=torch.float32, device=x.device)
    ext = _build.extension()
    if route(t, x.dtype) == "scan":
        scratch = torch.empty(ext.rglru_scan_scratch_bytes(b, t, d),
                              dtype=torch.uint8, device=x.device)
        ext.rglru_scan_chunked(x, a, gate_x, h0, y, h_last, scratch)
    else:
        if b > _MAX_GRID_Y:
            raise ValueError(f"rglru_scan: B must be at most {_MAX_GRID_Y} "
                             f"on the seq route, got {b}")
        ext.rglru_scan(x, a, gate_x, h0, y, h_last)
    _build.LAUNCHES["rglru_scan"] += 1
    return y, h_last
