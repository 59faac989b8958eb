"""Plain PyTorch versions of the kernels: the oracles and CPU paths.

Each function here computes what its counterpart in
``repro/kernels/ref.py`` computes, in straightforward tensor code, and
``attention_qchunk`` and ``attention_swa`` port
``repro/kernels/ops.py::_xla_attention_qchunk`` and ``_xla_attention_swa``;
``mlstm_chunkwise_torch`` and ``mlstm_step`` port the mLSTM functions of
``repro/models/layers.py``, which the layers call from here.  The CUDA
wrappers (``fedavg.py``, ``quantize.py``, ``attention.py``,
``rglru.py``, ``mlstm.py``) use them for tensors that lie on the CPU,
the tests compare them with the JAX oracles, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


# ----------------------------------------------------------------------
# Attention oracle (causal / sliding-window / softcap / GQA)
# ----------------------------------------------------------------------

def attention_mask(q_len: int, kv_len: int, *, causal: bool,
                   window: int | None, q_offset: int = 0,
                   kv_offset: int = 0, device=None) -> torch.Tensor:
    """(q_len, kv_len) bool mask.  Query i sits at absolute position
    ``q_offset + i``; key j at ``kv_offset + j`` (negative key positions
    are invalid).  ``window`` w keeps keys with
    ``q_pos - w < k_pos <= q_pos``."""
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    k_pos = kv_offset + torch.arange(kv_len, device=device)[None, :]
    mask = (k_pos >= 0).expand(q_len, kv_len)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    return mask


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int | None = None,
        softcap: float | None = None, q_offset: int = 0,
        kv_offset: int = 0, scale: float | None = None) -> torch.Tensor:
    """Reference multi-head attention, all math in f32.

    q: (B, Hq, Tq, D); k, v: (B, Hkv, Tk, D) with Hq % Hkv == 0 (GQA).
    Returns (B, Hq, Tq, D) in q.dtype.
    """
    b, hq, tq, d = q.shape
    group = hq // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    sc = (d ** -0.5) if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sc
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_mask(tq, k.shape[2], causal=causal, window=window,
                          q_offset=q_offset, kv_offset=kv_offset,
                          device=q.device)
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # Fully-masked rows (possible with windows) -> zeros, not NaN.
    p = torch.where(mask.any(-1)[None, None, :, None], p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def attention_qchunk(q, k, v, *, causal=True, window=None, softcap=None,
                     q_offset=0, kv_offset=0, scale=None, block_q=512):
    """Port of ``_xla_attention_qchunk``: peak memory O(block_q * Tk)
    per head, plain einsum and softmax in f32, GQA without repeating
    K/V (query head h reads KV head h // group).  The plain version of
    the ``flash_attention`` kernel, and ``ops.attention(impl="torch")``
    where the two-block route (``attention_swa``) does not apply.

    When grad is enabled and an input requires it, each q block runs
    under non-reentrant ``torch.utils.checkpoint``, as JAX wraps its
    block in ``jax.checkpoint(..., nothing_saveable)``: backward keeps
    the block inputs and recomputes one block's f32 scores at a time.
    The block reads no thread-local state, so autograd's device thread
    recomputes it as the forward ran it.
    """
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    group = hq // hkv
    sc = (d ** -0.5) if scale is None else scale
    block_q = max(1, min(block_q, tq))
    pad_q = (-tq) % block_q
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, pad_q))
    nq = q.shape[2] // block_q
    kf = k.float()
    vf = v.float()
    k_pos = kv_offset + torch.arange(tk, device=q.device)[None, :]

    def one_block(qi, qblk, kf, vf):
        qg = qblk.float().reshape(b, hkv, group, block_q, d)
        s = torch.einsum("bkgqd,bktd->bkgqt", qg, kf) * sc
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        q_pos = (q_offset + qi * block_q
                 + torch.arange(block_q, device=q.device))[:, None]
        mask = (k_pos >= 0).expand(block_q, tk)
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window is not None:
            mask = mask & (k_pos > q_pos - window)
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        p = torch.where(mask.any(-1)[:, None], p, 0.0)
        o = torch.einsum("bkgqt,bktd->bkgqd", p, vf)
        return o.reshape(b, hq, block_q, d)

    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    outs = []
    for qi in range(nq):
        qblk = q[:, :, qi * block_q:(qi + 1) * block_q]
        outs.append(checkpoint(one_block, qi, qblk, kf, vf,
                               use_reentrant=False) if remat
                    else one_block(qi, qblk, kf, vf))
    out = outs[0] if nq == 1 else torch.cat(outs, dim=2)
    return out[:, :, :tq].to(q.dtype)


def attention_swa(q, k, v, *, softcap=None, scale=None, window):
    """Port of ``_xla_attention_swa``: causal sliding-window attention
    over a full sequence (Tq == Tk, both offsets 0) in blocks of
    ``window`` rows, each q block against the two-block strip of k/v
    blocks (i - 1, i), zeros before block 0.  Work and peak memory are
    O(T * window), not O(T^2).  f32 math, GQA without repeating K/V,
    softcap, rows with no live key 0.  ``ops.attention(impl="torch")``
    takes it under JAX's condition (``ops.swa_route``).
    """
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    if tq != tk:
        raise ValueError(f"attention_swa needs Tq == Tk, got {tq}, {tk}")
    group = hq // hkv
    sc = (d ** -0.5) if scale is None else scale
    bs = window
    pad = (-tq) % bs
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                   for t in (q, k, v))
    t = q.shape[2]
    nb = t // bs
    qg = q.reshape(b, hkv, group, nb, bs, d).float()
    kb = k.reshape(b, hkv, nb, bs, d).float()
    vb = v.reshape(b, hkv, nb, bs, d).float()
    # The previous k/v block (zeros for block 0).
    kprev = torch.nn.functional.pad(kb[:, :, :-1], (0, 0, 0, 0, 1, 0))
    vprev = torch.nn.functional.pad(vb[:, :, :-1], (0, 0, 0, 0, 1, 0))
    k2 = torch.cat([kprev, kb], dim=3)              # (b, hkv, nb, 2bs, d)
    v2 = torch.cat([vprev, vb], dim=3)
    s = torch.einsum("bkgnqd,bkntd->bkgnqt", qg, k2) * sc
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    # Positions within the strip: q at bs + i, k at j.
    ar = torch.arange(2 * bs, device=q.device)
    q_pos = bs + ar[:bs, None]
    k_pos = ar[None, :]
    mask = (k_pos <= q_pos) & (k_pos > q_pos - window)
    # Block 0 has no previous block (its strip's left half is padding).
    blk = torch.arange(nb, device=q.device)[:, None, None]
    mask = mask[None] & ((k_pos[None] >= bs) | (blk > 0))
    if pad:                                         # padded tail keys
        mask = mask & (blk * bs + (k_pos[None] - bs) < tk)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[..., None], p, 0.0)
    o = torch.einsum("bkgnqt,bkntd->bkgnqd", p, v2)
    return o.reshape(b, hq, t, d)[:, :, :tq].to(q.dtype)


def attention_split_decode(q, k, v, ranges, *, causal=True, window=None,
                           softcap=None, q_offset=0, kv_offset=0,
                           scale=None):
    """Plain mirror of the split-KV decode kernel: for each key range
    [lo, hi] of ``ranges`` (empty when hi < lo) the f32 partials o
    (unnormalised), m (the live max, -1e30 with no live key) and l (0
    with no live key); then the max-rescaled sum over the splits with
    l > 0, and 0 for a row with no live key anywhere.  Tests and
    ``chip_smoke.py`` hold it against the attention oracles."""
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    group = hq // hkv
    sc = (d ** -0.5) if scale is None else scale
    qg = q.float().reshape(b, hkv, group, tq, d)
    mask = attention_mask(tq, tk, causal=causal, window=window,
                          q_offset=q_offset, kv_offset=kv_offset,
                          device=q.device)
    os_, ms, ls = [], [], []
    for lo, hi in ranges:
        kf = k[:, :, lo:hi + 1].float()
        vf = v[:, :, lo:hi + 1].float()
        s = torch.einsum("bkgqd,bktd->bkgqt", qg, kf) * sc
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        live = mask[:, lo:hi + 1]
        s = torch.where(live, s, NEG_INF)
        m = torch.full(s.shape[:-1], NEG_INF, device=q.device)
        if s.shape[-1]:
            m = torch.maximum(m, s.amax(-1))
        p = torch.where(live, torch.exp(s - m[..., None]), 0.0)
        os_.append(torch.einsum("bkgqt,bktd->bkgqd", p, vf))
        ms.append(m)
        ls.append(p.sum(-1))
    o, m, l = torch.stack(os_), torch.stack(ms), torch.stack(ls)
    has = l > 0
    m_max = torch.where(has, m, NEG_INF).amax(0)
    w = torch.where(has, torch.exp(m - m_max), 0.0)
    l_sum = (w * l).sum(0)
    o_sum = (w[..., None] * o).sum(0)
    out = torch.where(l_sum[..., None] > 0,
                      o_sum / torch.where(l_sum > 0, l_sum, 1.0)[..., None],
                      0.0)
    return out.reshape(b, hq, tq, d).to(q.dtype)


# ----------------------------------------------------------------------
# RG-LRU oracle (diagonal gated linear recurrence, De et al. 2024)
# ----------------------------------------------------------------------

def rglru(x: torch.Tensor, a: torch.Tensor, gate_x: torch.Tensor,
          h0: torch.Tensor | None = None
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * (gx_t * x_t).

    x, a, gate_x: (B, T, D), f32 arithmetic.  Returns (y (B, T, D) in
    ``x.dtype``, h_T (B, D) f32), from ``h0`` (zeros when absent): a
    sequential loop over T, the plain version of the ``rglru_scan``
    kernel.
    """
    xf, af, gx = x.float(), a.float(), gate_x.float()
    inp = torch.sqrt(torch.clamp(1.0 - af * af, min=0.0)) * (gx * xf)
    h = (torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32,
                     device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(x.shape[1]):
        h = af[:, t] * h + inp[:, t]
        ys.append(h)
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros_like(xf))
    return y.to(x.dtype), h


RGLRU_SUBS = 4          # the scan route's sub-chunks a chunk (kSubs)


def rglru_chunked(x: torch.Tensor, a: torch.Tensor, gate_x: torch.Tensor,
                  h0: torch.Tensor | None = None, *, chunk: int,
                  lookback: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """The same function as ``rglru`` in the association of the
    ``rglru_scan`` kernel's "scan" route, the plain mirror the tests
    hold against the reference.  T is cut into chunks of ``chunk``
    rows, each into ``RGLRU_SUBS`` sub-chunks (a missing row of the
    last chunk is a = 1 with a zero input term).  Each sub-chunk runs
    from h = 0 to its aggregate (A = prod a, H = end state); a chunk's
    aggregate folds its sub-chunks; a chunk's start state folds the
    aggregates of up to ``lookback - 1`` chunks before it onto the
    inclusive prefix A h_in + H of the chunk before those (chunk 0
    starts at ``h0``), as the kernel's look-back does when it finds the
    prefix that far back; each sub-chunk then rescans from its own
    start state."""
    b, t, d = x.shape
    if t == 0:
        return rglru(x, a, gate_x, h0)
    xf, af, gx = x.float(), a.float(), gate_x.float()
    inp = torch.sqrt(torch.clamp(1.0 - af * af, min=0.0)) * (gx * xf)
    subs = RGLRU_SUBS
    rows = chunk // subs
    n = -(-t // chunk)
    pad = n * chunk - t
    af = torch.nn.functional.pad(af, (0, 0, 0, pad), value=1.0)
    inp = torch.nn.functional.pad(inp, (0, 0, 0, pad))
    af = af.reshape(b, n, subs, rows, d)
    inp = inp.reshape(b, n, subs, rows, d)
    # sub-chunk aggregates, (b, n, subs, d)
    sa = torch.ones_like(af[:, :, :, 0])
    sh = torch.zeros_like(sa)
    for r in range(rows):
        sh = af[:, :, :, r] * sh + inp[:, :, :, r]
        sa = sa * af[:, :, :, r]
    # chunk aggregates, (b, n, d)
    ca = torch.ones_like(sa[:, :, 0])
    ch = torch.zeros_like(ca)
    for s in range(subs):
        ch = sa[:, :, s] * ch + sh[:, :, s]
        ca = sa[:, :, s] * ca
    h_in: list = []
    prefix: list = []
    for c in range(n):
        if c == 0:
            hin = (torch.zeros((b, d), dtype=torch.float32, device=x.device)
                   if h0 is None else h0.float())
        else:
            k = max(c - lookback, 0)
            mul = torch.ones_like(ca[:, 0])
            add = torch.zeros_like(mul)
            for j in range(c - 1, k, -1):
                add = mul * ch[:, j] + add
                mul = mul * ca[:, j]
            hin = mul * prefix[k] + add
        h_in.append(hin)
        prefix.append(ca[:, c] * hin + ch[:, c])
    # each sub-chunk's start state, then the rescan
    h = torch.stack(h_in, dim=1)
    starts = []
    for s in range(subs):
        starts.append(h)
        h = sa[:, :, s] * h + sh[:, :, s]
    h = torch.stack(starts, dim=2)
    ys = []
    for r in range(rows):
        h = af[:, :, :, r] * h + inp[:, :, :, r]
        ys.append(h)
    y = torch.stack(ys, dim=3).reshape(b, n * chunk, d)[:, :t]
    return y.to(x.dtype), y[:, -1].clone()


# ----------------------------------------------------------------------
# Chunkwise mLSTM (xLSTM matrix memory, Beck et al. 2024)
# ----------------------------------------------------------------------

def mlstm_pad(q, k, v, i_pre, f_pre, chunk: int):
    """Pad T (dim 1) of the (B, T, H, ...) mLSTM inputs to a multiple of
    ``chunk`` with inert steps: zero q, k, v and f (A stays flat), and
    i = -1e30 (adds nothing).  Returns the five tensors, as given when
    T is already a multiple."""
    pad = (-q.shape[1]) % chunk
    if not pad:
        return q, k, v, i_pre, f_pre
    q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
               for x in (q, k, v))
    return (q, k, v,
            torch.nn.functional.pad(i_pre, (0, 0, 0, pad), value=NEG_INF),
            torch.nn.functional.pad(f_pre, (0, 0, 0, pad)))


def mlstm_chunkwise_torch(q, k, v, i_pre, f_pre, state, *, chunk: int,
                          remat: bool = False):
    """Chunkwise-parallel mLSTM with stabilised exponential gating.

    Port of ``repro/models/layers.py::_mlstm_chunkwise``, op for op.
    Per head, relative to the chunk's start, with A the inclusive cumsum
    of f:

        M_j = max(m0, cummax_j(i - A)),   W[j,s] = e^{(i_s - A_s) - M_j}
        h_j = e^{m0-M_j} C0 q_j + sum_{s<=j} W[j,s] (k_s.q_j) v_s
        n_j = e^{m0-M_j} n0 + sum_{s<=j} W[j,s] k_s
        h_j /= max(|n_j . q_j|, 1)

    and the state at the chunk's end uses the same weights at j = L-1.
    ``chunk`` is cut to T, and T is padded to a multiple of it with
    inert steps (``mlstm_pad``).  With ``remat`` and grad enabled each
    chunk is checkpointed, so backward keeps only the chunk-boundary
    states.

    q, k, v: (B, T, H, dh) (q, k pre-scaled); i_pre, f_pre: (B, T, H).
    state: (C (B, H, dh, dh), n (B, H, dh), m (B, H)).  Returns
    (state, h (B, T, H, dh) f32).
    """
    b, t, hh, dh = q.shape
    chunk = min(chunk, t)
    q, k, v, i_pre, f_pre = mlstm_pad(q, k, v, i_pre, f_pre, chunk)
    nc = q.shape[1] // chunk

    def chunk_body(C0, n0, m0, qc, kc, vc, ic, fc):
        L = qc.shape[1]
        ic = ic.float().transpose(1, 2)                    # (b,h,L)
        fc = fc.float().transpose(1, 2)
        qh = qc.float().transpose(1, 2)                    # (b,h,L,dh)
        kh = kc.float().transpose(1, 2)
        vh = vc.float().transpose(1, 2)

        A = torch.cumsum(fc, dim=-1)                       # (b,h,L)
        gia = ic - A                                       # i_s - A_s
        g = torch.cummax(gia, dim=2).values
        M = torch.maximum(m0[..., None], g)                # (b,h,L)
        c_int = torch.exp(m0[..., None] - M)
        # W[j,s] = exp(gia_s - M_j), s <= j
        W = torch.exp(gia[..., None, :] - M[..., :, None])
        mask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                     device=W.device))
        W = torch.where(mask, W, 0.0)

        scores = torch.einsum("bhjd,bhsd->bhjs", qh, kh)
        inter_num = torch.einsum("bhij,bhsj->bhsi", C0, qh)  # C0 q_j
        h_num = (c_int[..., None] * inter_num
                 + torch.einsum("bhjs,bhsi->bhji", W * scores, vh))
        nj = (c_int[..., None] * n0[:, :, None, :]
              + torch.einsum("bhjs,bhsd->bhjd", W, kh))
        den = torch.abs(torch.einsum("bhjd,bhjd->bhj", nj, qh))
        h = h_num / torch.clamp(den, min=1.0)[..., None]  # (b,h,L,dh)

        # end-of-chunk state
        AL = A[..., -1]
        MxL = torch.maximum(m0, g[..., -1])                # (b,h)
        wL = torch.exp(gia - MxL[..., None])               # (b,h,L)
        C = (torch.exp(m0 - MxL)[..., None, None] * C0
             + torch.einsum("bhs,bhsi,bhsj->bhij", wL, vh, kh))
        n = (torch.exp(m0 - MxL)[..., None] * n0
             + torch.einsum("bhs,bhsd->bhd", wL, kh))
        m = AL + MxL
        return C, n, m, h.transpose(1, 2)                  # (b,L,h,dh)

    remat = remat and torch.is_grad_enabled()
    C, n, m = state
    hs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xs = (q[:, sl], k[:, sl], v[:, sl], i_pre[:, sl], f_pre[:, sl])
        if remat:
            C, n, m, h = checkpoint(chunk_body, C, n, m, *xs,
                                    use_reentrant=False)
        else:
            C, n, m, h = chunk_body(C, n, m, *xs)
        hs.append(h)
    return (C, n, m), torch.cat(hs, dim=1)[:, :t]


def mlstm_zero_state(b: int, hh: int, dh: int, device=None):
    """The mLSTM's initial state: C (B, H, dh, dh) and n (B, H, dh)
    zero, m (B, H) at -1e30, all f32."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((b, hh, dh, dh), **f32),
            torch.zeros((b, hh, dh), **f32),
            torch.full((b, hh), NEG_INF, **f32))


def mlstm_chunkwise(q, k, v, i_pre, f_pre, *, chunk: int = 128):
    """The ``mlstm_chunkwise`` kernel's function from a zero state, in
    its layout: q, k, v (B, H, T, dh) (q, k pre-scaled), i_pre, f_pre
    (B, H, T) -> (h (B, H, T, dh) in ``q.dtype``, C (B, H, dh, dh),
    n (B, H, dh), m (B, H), all f32).  The port of JAX's
    ``ops.mlstm(impl="xla")``: ``mlstm_chunkwise_torch`` on transposed
    views, with h cast to q's dtype as the kernel writes it (JAX's form
    keeps it f32)."""
    b, hh, _, dh = q.shape
    (C, n, m), hs = mlstm_chunkwise_torch(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        i_pre.transpose(1, 2), f_pre.transpose(1, 2),
        mlstm_zero_state(b, hh, dh, q.device), chunk=chunk)
    return hs.transpose(1, 2).to(q.dtype), C, n, m


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to tf32's 10 mantissa bits, to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does (finite inputs)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the tensor-core route computes it: each operand split
    into hi = tf32(x) and lo = tf32(x - hi), then hi hi + hi lo + lo hi
    with f32 accumulation (the lo lo term is dropped)."""
    ah, bh = tf32_round(a), tf32_round(b)
    al, bl = tf32_round(a.float() - ah), tf32_round(b.float() - bh)
    return ah @ bh + (ah @ bl + al @ bh)


def mlstm_chunkwise_split(q, k, v, i_pre, f_pre, *, chunk: int = 128,
                          matmul=torch.matmul):
    """``mlstm_chunkwise`` computed as the tensor-core route's three
    passes compute it; every matrix product goes through ``matmul``
    (``matmul_3xtf32`` emulates the route's products).  Layout and
    results as ``mlstm_chunkwise``; T a multiple of ``chunk``.

    a. gates, per (b, h), chunk by chunk (the carried m0 only):
       M_j = max(m0, cummax(i - A)_j), c_j = e^{m0 - M_j},
       wL_s = e^{gia_s - M_{L-1}}, decay = e^{m0 - M_{L-1}},
       m = A_{L-1} + M_{L-1};
    b. intra-chunk, per (b, h, chunk), independent of the state:
       S = q k^T, P = W o S (W[j, s] = e^{gia_s - M_j}, s <= j),
       rs_j = sum_s P[j, s], H = P v;
    c. inter-chunk, per (b, h), walking the chunks with C and n:
       h_j = (c_j (C q_j) + H_j) / max(|c_j (n . q_j) + rs_j|, 1),
       C <- decay C + (wL o v)^T k,  n <- decay n + sum_s wL_s k_s."""
    b, hh, t, dh = q.shape
    L = chunk
    nc = t // L
    f32 = lambda x: x.float().reshape(b, hh, nc, L, *x.shape[3:])  # noqa: E731
    qc, kc, vc, ic, fc = f32(q), f32(k), f32(v), f32(i_pre), f32(f_pre)
    # a. gates
    A = torch.cumsum(fc, dim=-1)
    gia = ic - A                                         # (b, h, nc, L)
    g = torch.cummax(gia, dim=-1).values
    m0 = torch.full((b, hh), NEG_INF, dtype=torch.float32, device=q.device)
    Ms, m0s = [], []
    for c in range(nc):
        m0s.append(m0)
        Ms.append(torch.maximum(m0[..., None], g[:, :, c]))
        m0 = A[:, :, c, -1] + Ms[-1][..., -1]
    M = torch.stack(Ms, dim=2)                           # (b, h, nc, L)
    m_prev = torch.stack(m0s, dim=2)                     # (b, h, nc)
    c_j = torch.exp(m_prev[..., None] - M)
    wL = torch.exp(gia - M[..., -1:])
    decay = torch.exp(m_prev - M[..., -1])
    # b. intra-chunk
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    W = torch.where(mask, torch.exp(gia[..., None, :] - M[..., :, None]), 0.0)
    P = W * matmul(qc, kc.transpose(-1, -2))             # (b, h, nc, L, L)
    rs = P.sum(-1)
    H = matmul(P, vc)                                    # (b, h, nc, L, dh)
    # c. inter-chunk
    C = torch.zeros((b, hh, dh, dh), dtype=torch.float32, device=q.device)
    n = torch.zeros((b, hh, dh), dtype=torch.float32, device=q.device)
    hs = []
    for c in range(nc):
        qj = qc[:, :, c]
        Y = matmul(qj, C.transpose(-1, -2))              # C0 q_j, (b,h,L,dh)
        qn = (qj * n[:, :, None, :]).sum(-1)
        cj = c_j[:, :, c]
        den = torch.clamp(torch.abs(cj * qn + rs[:, :, c]), min=1.0)
        hs.append((cj[..., None] * Y + H[:, :, c]) / den[..., None])
        wv = wL[:, :, c, :, None] * vc[:, :, c]          # (b, h, L, dh)
        C = decay[:, :, c, None, None] * C + matmul(wv.transpose(-1, -2),
                                                     kc[:, :, c])
        n = decay[:, :, c, None] * n + (wL[:, :, c, :, None]
                                        * kc[:, :, c]).sum(-2)
    h = torch.cat(hs, dim=2).to(q.dtype)
    return h, C, n, m0


def mlstm_step(state, inputs):
    """One mLSTM cell step (stabilised exponential gating); port of
    ``repro/models/layers.py::_mlstm_step``.  state: (C (B, H, dh, dh),
    n (B, H, dh), m (B, H)); inputs: q, k, v (B, H, dh), i_pre, f_pre
    (B, H).  Returns (state, h (B, H, dh))."""
    C, nrm, m = state
    q_t, k_t, v_t, i_pre, f_pre = inputs
    m_new = torch.maximum(f_pre + m, i_pre)                # (B, H)
    fi = torch.exp(f_pre + m - m_new)
    ii = torch.exp(i_pre - m_new)
    C = fi[..., None, None] * C + ii[..., None, None] * (
        v_t[..., :, None] * k_t[..., None, :])             # (B,H,dh,dh)
    nrm = fi[..., None] * nrm + ii[..., None] * k_t
    num = torch.einsum("bhij,bhj->bhi", C, q_t)
    den = torch.abs(torch.einsum("bhj,bhj->bh", nrm, q_t))
    h = num / torch.clamp(den, min=1.0)[..., None]
    return (C, nrm, m_new), h


# ----------------------------------------------------------------------
# Masked FedAvg reduction (paper §II-B aggregation)
# ----------------------------------------------------------------------

def masked_normalized_weights(weights: torch.Tensor,
                              active: torch.Tensor) -> torch.Tensor:
    """FedAvg weights w_u m_u / sum w_u m_u, (n,) f32.

    Zero active mass (every client masked or weightless) yields zeros,
    never 0/0 NaN.  Shared by the CUDA wrapper, the plain version below
    and the torrent aggregate (dist/torrent.py).
    """
    w = weights.float() * active.float()
    total = w.sum()
    return torch.where(total > 0, w / torch.clamp(total, min=1e-12),
                       torch.zeros_like(w))


def mask_inactive_rows(updates: torch.Tensor,
                       wn: torch.Tensor) -> torch.Tensor:
    """Select out rows with zero weight BEFORE the weighted reduction.

    A masked client's update may be the reason it was masked (a
    diverged local step gives inf/NaN grads); 0 * NaN == NaN would
    poison the aggregate, so zero-weight rows are replaced, not
    multiplied.
    """
    return torch.where((wn > 0)[:, None], updates,
                       torch.zeros((), dtype=updates.dtype,
                                   device=updates.device))


def fedavg_reduce(updates: torch.Tensor, weights: torch.Tensor,
                  active: torch.Tensor) -> torch.Tensor:
    """FedAvg over the reconstructable active set.

    updates: (n, D); weights: (n,) aggregation weights; active: (n,)
    mask.  Returns (D,) = sum_u m_u w_u x_u / sum_u m_u w_u in
    ``updates.dtype``.
    """
    wn = masked_normalized_weights(weights, active)
    masked = mask_inactive_rows(updates.float(), wn)
    return torch.einsum("n,nd->d", wn, masked).to(updates.dtype)


# ----------------------------------------------------------------------
# Chunk quantization (int8 symmetric per chunk)
# ----------------------------------------------------------------------

def chunk_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (n_chunks, chunk_elems) -> (int8 codes, f32 scales (n, 1)).

    ``torch.round`` rounds half to even, as ``jnp.round`` does, and both
    divisions are true f32 divisions, so the codes equal the JAX
    oracle's bit for bit.  (On CUDA, PyTorch turns a division by a
    Python scalar into a multiplication by its reciprocal, which can be
    one ulp off; hence the 0-d tensor divisor.)
    """
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / amax.new_tensor(127.0), 1.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def chunk_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
