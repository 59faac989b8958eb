"""Flash attention forward (causal / window / softcap / GQA): CUDA wrapper.

The kernels in ``csrc/attention.cu`` replace the Pallas TPU kernel
``repro/kernels/attention.py::flash_attention``.  ``route`` picks one of
three from the dtype, Tq and D alone:

* ``"split-KV decode"`` (Tq <= ``DECODE_ROWS``, f32 or bf16, any head
  dim): the live key range is cut into the splits of ``split_plan``; a
  CTA reads one split of one KV head once and computes every query row
  of that head's group, writing f32 partials (o, m, l) that a second
  launch combines;
* ``"wgmma prefill"`` (bf16, D in ``WGMMA_HEAD_DIMS``): Q K^T and P V on
  the tensor cores (P rounded to bf16), K/V fed by TMA through a
  two-stage ring, one CTA per (batch, query head, 128 query rows);
* ``"FMA"`` (the rest: f32 prefill, bf16 at D in {16, 32, 80}): f32 FMA
  on the CUDA cores, one CTA per (batch, query head, 64 query rows).

Every route skips the keys the causal mask, the window or the rolling
cache's negative key positions rule out.  ``q_offset`` is the absolute
position of query row 0 and ``kv_offset`` that of key 0 (negative in a
rolling decode cache, whose first entries are then masked).  For
tensors on the CPU the wrapper runs the plain version
(``ref.attention_qchunk``); for CUDA tensors it launches its route's
kernel or raises: nothing is caught and nothing falls back.  It has no
backward of its own: ``ops.attention`` wraps it in a
``torch.autograd.Function`` that recomputes through the plain version,
as JAX's ``custom_vjp`` does.
"""
from __future__ import annotations

import torch

from . import _build, ref

HEAD_DIMS = (16, 32, 64, 80, 128, 256)
WGMMA_HEAD_DIMS = (64, 128, 256)
DECODE_ROWS = 4          # at most this many query rows: split-KV decode
DECODE_CTAS = 512        # the split plan aims at this many CTAs (132 SMs)
MIN_SPLIT_KEYS = 64      # and gives no split fewer keys than this
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535
_MAX_GRID_X = 2 ** 31 - 1


def route(dtype: torch.dtype, tq: int, d: int) -> str:
    """The kernel that serves these inputs on the card."""
    if tq <= DECODE_ROWS:
        return "split-KV decode"
    if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS:
        return "wgmma prefill"
    return "FMA"


def split_plan(b: int, hkv: int, tq: int, tk: int, *, causal: bool,
               window: int | None, q_offset: int,
               kv_offset: int) -> tuple[int, int, int, int]:
    """(j_lo, j_hi, per, splits) of the split-KV decode: split s covers
    keys [j_lo + s * per, min(j_lo + (s + 1) * per - 1, j_hi)].  About
    ``DECODE_CTAS`` CTAs over the B x Hkv heads, no split under
    ``MIN_SPLIT_KEYS`` keys unless the live range is, and none past it.
    With no live key: one empty split (per = 0).  [j_lo, j_hi] are the
    keys some query row may attend to, as the kernel's range."""
    j_lo = max(0, -kv_offset)
    if window is not None:
        j_lo = max(j_lo, q_offset - window + 1 - kv_offset)
    j_hi = tk - 1
    if causal:
        j_hi = min(j_hi, q_offset + tq - 1 - kv_offset)
    live = j_hi - j_lo + 1
    if live <= 0:
        return j_lo, j_hi, 0, 1
    want = -(-DECODE_CTAS // max(1, b * hkv))
    splits = max(1, min(want, live // MIN_SPLIT_KEYS))
    per = -(-live // splits)
    return j_lo, j_hi, per, -(-live // per)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned start (the kernels read 16 or
    8 bytes at a time, and TMA needs 16)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, q_offset: int = 0,
                    kv_offset: int = 0, scale: float | None = None,
                    block_q: int = 512) -> torch.Tensor:
    """q (B, Hq, Tq, D); k, v (B, Hkv, Tk, D) -> (B, Hq, Tq, D) in
    ``q.dtype``.  ``block_q`` sizes only the plain version's chunks."""
    if _build.plain_route(q):
        return ref.attention_qchunk(q, k, v, causal=causal, window=window,
                                    softcap=softcap, q_offset=q_offset,
                                    kv_offset=kv_offset, scale=scale,
                                    block_q=block_q)
    _build.require_cuda("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q must be (B, Hq, Tq, D) and "
                         f"k, v (B, Hkv, Tk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, tq, d = q.shape
    _, hkv, tk, dk = k.shape
    if k.shape[0] != b or dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match (GQA needs "
                         f"Hq % Hkv == 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} is not one of "
                         f"{HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share float32 or "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if b > _MAX_GRID_YZ or hq > _MAX_GRID_YZ or b * hq > _MAX_GRID_X:
        raise ValueError(f"flash_attention: B and Hq must be at most "
                         f"{_MAX_GRID_YZ} and B * Hq at most {_MAX_GRID_X},"
                         f" got {b} and {hq}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap must be positive, got "
                         f"{softcap}")
    if window is not None and window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got "
                         f"{window}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    args = (bool(causal), -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap), int(q_offset),
            int(kv_offset), float(d ** -0.5 if scale is None else scale))
    path = route(q.dtype, tq, d)
    ext = _build.extension()
    if path == "split-KV decode":
        j_lo, j_hi, per, splits = split_plan(
            b, hkv, tq, tk, causal=causal, window=window, q_offset=q_offset,
            kv_offset=kv_offset)
        # the f32 partials o (splits, rows, d), m and l (splits, rows),
        # in one allocation
        n = splits * b * hq * tq
        part = torch.empty(n * (d + 2), dtype=torch.float32,
                           device=q.device)
        o_part, m_part, l_part = part.split((n * d, n, n))
        ext.flash_decode(q, k, v, out, o_part, m_part, l_part, *args, j_lo,
                         j_hi, per, splits)
    elif path == "wgmma prefill":
        ext.flash_attention_wgmma(q, k, v, out, *args)
    else:
        ext.flash_attention(q, k, v, out, *args)
    _build.LAUNCHES["flash_attention"] += 1
    return out
