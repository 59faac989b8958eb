"""Chunkwise-parallel mLSTM from a zero state: CUDA wrapper.

xLSTM's matrix memory (Beck et al., "xLSTM", 2024), the fused form of
``ref.mlstm_chunkwise_torch``.  The kernels in ``csrc/mlstm.cu`` replace
the Pallas TPU kernel ``repro/kernels/mlstm.py::mlstm_chunkwise``.  The
function's work is bound by its operations (4·L·dh² + 2·dh·L(L+1) per
(b, h, chunk)), so the aim is the tensor cores.  ``route`` picks one of
two kernels from the dtype, dh and chunk alone:

* ``"tc"`` (f32 or bf16, chunk 64 or 128, dh a multiple of 32 from 32
  to 512): every product on TF32 ``wgmma`` with the 3xTF32 split
  (hi = tf32(x), lo = tf32(x - hi); hi·hi + hi·lo + lo·hi), which keeps
  the f32 tolerance; one TF32 product per product, emulated on the CPU,
  comes close to the 5e-4 check.  Three launches: a gate pass (one
  warp per (b, h) walks the chunks' cumsum, cummax and stabiliser), an
  intra-chunk pass (one CTA per (b, h, chunk) computes the scores once,
  P = W o S, its row sums and H = P v) and an inter-chunk pass (one CTA
  per (b, h, 64 value rows of C) walks the chunks with its rows of C in
  registers: C0 q, the output h, then the C and n update).  q, k and v
  arrive by TMA while the previous step's products run.
  ``ref.mlstm_chunkwise_split`` is the plain mirror of the three passes;
* ``"fma"`` (the rest: chunk 1, 16, 32 or 100, dh 8, 48 or 80, ...): the
  first kernel, f32 FMA on the CUDA cores, one CTA per (b, h, block of
  32 value rows of C) with its rows of C resident in shared memory.

Either way the wrapper counts one launch of ``mlstm_chunkwise`` per
call.  The kernels read q, k, v and write h through (b, h, t) strides,
so the layer hands them transposed views of its (B, T, H, dh) tensors
and gets h back in that layout without a copy; ``h`` is allocated with
q's strides.  Inputs of any other layout are made contiguous first.

For tensors on the CPU the wrapper runs the plain version
(``ref.mlstm_chunkwise``); for CUDA tensors it launches its route's
kernels or raises.  Like the Pallas kernel it has no gradient:
``ops.mlstm`` wraps it in a ``torch.autograd.Function`` whose backward
raises.
"""
from __future__ import annotations

import torch

from . import _build, ref

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535
MAX_CHUNK = 128          # kMaxMlstmChunk in csrc/kernels.h
TC_CHUNKS = (64, 128)    # mlstm_tc_shape_ok in csrc/mlstm.cu
TC_MAX_DH = 512


def route(dtype: torch.dtype, dh: int, chunk: int) -> str:
    """The kernel that serves these inputs on the card: ``"tc"`` for f32
    or bf16 with chunk in ``TC_CHUNKS`` and dh a multiple of 32 from 32
    to ``TC_MAX_DH``, else ``"fma"``."""
    if (dtype in _DTYPES and chunk in TC_CHUNKS and dh % 32 == 0
            and 32 <= dh <= TC_MAX_DH):
        return "tc"
    return "fma"


def _dense_bhtd(t: torch.Tensor) -> bool:
    """(B, H, T, ...) contiguous, or the (1, 2) transpose of a
    contiguous (B, T, H, ...): the layouts the kernel's strides cover
    with a unit last stride."""
    return t.is_contiguous() or t.transpose(1, 2).is_contiguous()


def _shared_layout(*ts: torch.Tensor,
                   align: int = 1) -> tuple[torch.Tensor, ...]:
    """The tensors as given if they share one such layout and start at
    a multiple of ``align`` bytes, else contiguous copies."""
    s = ts[0].stride()
    if (_dense_bhtd(ts[0]) and all(t.stride() == s for t in ts)
            and all(t.data_ptr() % align == 0 for t in ts)):
        return ts
    return tuple(t.contiguous().clone() if t.data_ptr() % align else
                 t.contiguous() for t in ts)


def _check_shapes(q, k, v, i_pre, f_pre, chunk: int) -> None:
    """Raise unless q, k, v are one (B, H, T, dh) shape, i_pre and f_pre
    (B, H, T), and T a positive multiple of ``chunk`` <= MAX_CHUNK."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"mlstm_chunkwise: q, k, v must share one "
                         f"(B, H, T, dh) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if i_pre.shape != q.shape[:3] or f_pre.shape != q.shape[:3]:
        raise ValueError(f"mlstm_chunkwise: i_pre and f_pre must be "
                         f"{tuple(q.shape[:3])}, got {tuple(i_pre.shape)}, "
                         f"{tuple(f_pre.shape)}")
    t = q.shape[2]
    if not 1 <= chunk <= MAX_CHUNK or t == 0 or t % chunk:
        raise ValueError(f"mlstm_chunkwise: T ({t}) must be a positive "
                         f"multiple of chunk ({chunk}), and chunk at most "
                         f"{MAX_CHUNK}")


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_pre: torch.Tensor, f_pre: torch.Tensor, *,
                    chunk: int = 128):
    """q, k, v (B, H, T, dh) (q, k pre-scaled); i_pre, f_pre (B, H, T)
    f32 -> (h (B, H, T, dh) in ``q.dtype``, C (B, H, dh, dh), n (B, H,
    dh), m (B, H), all f32), from a zero state.  T must be a multiple of
    ``chunk``."""
    _check_shapes(q, k, v, i_pre, f_pre, chunk)
    if _build.plain_route(q):
        return ref.mlstm_chunkwise(q, k, v, i_pre, f_pre, chunk=chunk)
    _build.require_cuda("mlstm_chunkwise", q, k, v, i_pre, f_pre)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"mlstm_chunkwise: q, k, v must share float32 or "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if i_pre.dtype != torch.float32 or f_pre.dtype != torch.float32:
        raise ValueError(f"mlstm_chunkwise: i_pre and f_pre must be "
                         f"float32, got {i_pre.dtype}, {f_pre.dtype}")
    b, hh, _, dh = q.shape
    if b > _MAX_GRID_YZ or hh > _MAX_GRID_YZ:
        raise ValueError(f"mlstm_chunkwise: B and H must be at most "
                         f"{_MAX_GRID_YZ}, got {b} and {hh}")
    ext = _build.extension()
    path = route(q.dtype, dh, chunk)
    if path == "fma" and not ext.mlstm_chunkwise_shape_ok(dh, chunk):
        raise ValueError(f"mlstm_chunkwise: head dim {dh} with chunk "
                         f"{chunk} does not fit the kernel's shared memory")
    # the tensor-core route reads q, k, v by TMA: 16-byte aligned
    q, k, v = _shared_layout(q, k, v, align=16 if path == "tc" else 1)
    i_pre, f_pre = _shared_layout(i_pre, f_pre)
    h = torch.empty_strided(q.shape, q.stride(), dtype=q.dtype,
                            device=q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    C = torch.empty((b, hh, dh, dh), **f32)
    n = torch.empty((b, hh, dh), **f32)
    m = torch.empty((b, hh), **f32)
    if path == "tc":
        t = q.shape[2]
        hbuf = h if h.dtype == torch.float32 else torch.empty_strided(
            q.shape, q.stride(), **f32)
        scratch = torch.empty(ext.mlstm_tc_scratch_floats(b, hh, t, chunk),
                              **f32)
        ext.mlstm_chunkwise_tc(q, k, v, i_pre, f_pre, h, hbuf, C, n, m,
                               scratch, int(chunk))
    else:
        ext.mlstm_chunkwise(q, k, v, i_pre, f_pre, h, C, n, m, int(chunk))
    _build.LAUNCHES["mlstm_chunkwise"] += 1
    return h, C, n, m
