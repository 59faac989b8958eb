"""The attention kernel's routes, held on the CPU where they can be.

The CUDA kernels of ``csrc/attention.cu`` run only on the card; what
surrounds them runs here.  ``route`` picks the kernel from the dtype, Tq
and D; ``split_plan`` cuts the live key range of the split-KV decode
route, which must cover that range exactly once; the plain mirror of
split-and-combine (``ref.attention_split_decode``) is held against the
Pallas kernel in interpret mode at f32 with ``atol = rtol = 3e-5``,
empty splits and negative key positions included; and an emulation of
the wgmma route's one rounding, P in bf16 before P V, stays within the
bf16 tolerance of ``chip_smoke.py`` (``1e-2``) of the f32 plain version
at a reduced gemma2-like shape.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import attention as jattention  # noqa: E402
from repro_torch.kernels import attention, ref  # noqa: E402

ATTN_TOL = 3e-5
BF16_TOL = 1e-2

# b, hq, hkv, tq, tk, d, causal, window, softcap, q_offset, kv_offset:
# the decode cases of chip_smoke.py's ATTN_CASES
DECODE_CASES = [
    (2, 4, 1, 1, 320, 64, True, None, None, 319, 0),
    (1, 4, 4, 1, 64, 32, True, 64, None, 100, 37),
    (1, 8, 4, 1, 64, 256, True, 64, 50.0, 10, -53),
    (2, 4, 2, 3, 100, 128, True, None, 50.0, 97, 0),
    (2, 10, 1, 1, 2048, 256, True, 2048, None, 2999, 952),
    (1, 10, 1, 3, 2048, 128, True, 2048, 50.0, 1000, -1047),
    (2, 8, 4, 3, 300, 64, True, None, None, 0, 1),
    (1, 4, 2, 1, 100, 32, True, None, None, 0, 5),
    (1, 16, 1, 4, 1000, 80, True, None, 30.0, 996, 0),
]
# the full-width decode shapes of chip_smoke.py (pos = prompt + 8)
FULL_DECODE = [
    (8, 8, 4, 1, 8224, 256, True, None, 50.0, 8200, 0),
    (8, 8, 4, 1, 4096, 256, True, 4096, 50.0, 8200, 8200 - 4095),
    (8, 10, 1, 1, 2048, 256, True, 2048, None, 8200, 8200 - 2047),
]


def _kw(case):
    return dict(causal=case[6], window=case[7], softcap=case[8],
                q_offset=case[9], kv_offset=case[10])


def _plan(case):
    kw = _kw(case)
    del kw["softcap"]
    return attention.split_plan(case[0], case[2], case[3], case[4], **kw)


def _ranges(j_lo, j_hi, per, splits):
    """Each split's [lo, hi] key range as the kernel takes it from the
    plan (hi < lo when empty)."""
    return [(j_lo + s * per, min(j_lo + (s + 1) * per - 1, j_hi))
            for s in range(splits)]


def _inputs(case, seed):
    b, hq, hkv, tq, tk, d = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, tq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, tk, d)).astype(np.float32),
            rng.normal(size=(b, hkv, tk, d)).astype(np.float32))


@pytest.mark.parametrize("dtype,tq,d,want", [
    (torch.bfloat16, 8192, 256, "wgmma prefill"),
    (torch.bfloat16, 200, 64, "wgmma prefill"),
    (torch.bfloat16, 5, 128, "wgmma prefill"),
    (torch.bfloat16, 96, 80, "FMA"),
    (torch.bfloat16, 96, 16, "FMA"),
    (torch.float32, 8192, 256, "FMA"),
    (torch.float32, 1, 256, "split-KV decode"),
    (torch.bfloat16, 1, 256, "split-KV decode"),
    (torch.bfloat16, 4, 80, "split-KV decode"),
])
def test_route_from_dtype_tq_and_head_dim(dtype, tq, d, want):
    assert attention.route(dtype, tq, d) == want


def _mask_range(case):
    """The live key indices from the plain mask itself: [lo, hi]."""
    tq, tk = case[3], case[4]
    live = ref.attention_mask(tq, tk, causal=case[6], window=case[7],
                              q_offset=case[9], kv_offset=case[10])
    idx = torch.nonzero(live.any(0)).flatten()
    return (int(idx[0]), int(idx[-1])) if idx.numel() else None


@pytest.mark.parametrize("case", DECODE_CASES + FULL_DECODE)
def test_split_plan_covers_the_live_range_once(case):
    b, hkv = case[0], case[2]
    j_lo, j_hi, per, splits = _plan(case)
    ranges = _ranges(j_lo, j_hi, per, splits)
    assert len(ranges) == splits >= 1
    live = _mask_range(case)
    if live is None:
        # no live key: one empty split, which the kernel leaves empty
        assert splits == 1 and per == 0 and ranges[0][1] < ranges[0][0]
        return
    assert (j_lo, j_hi) == live
    covered = [j for lo, hi in ranges for j in range(lo, hi + 1)]
    assert covered == list(range(j_lo, j_hi + 1))   # once, in order
    assert all(lo <= hi for lo, hi in ranges)        # no split past it
    assert all(hi - lo + 1 >= attention.MIN_SPLIT_KEYS
               for lo, hi in ranges[:-1]) or splits == 1
    # enough CTAs, capped by the live keys
    n_live = j_hi - j_lo + 1
    assert splits == max(1, min(-(-attention.DECODE_CTAS // (b * hkv)),
                                n_live // attention.MIN_SPLIT_KEYS))


def test_split_plan_at_full_width():
    """gemma2's global decode: 16 splits of about 514 keys (512 CTAs);
    recurrentgemma's 2048-key rolling cache: 32 splits of 64 keys."""
    plans = [_plan(c) for c in FULL_DECODE]
    assert [(p[2], p[3]) for p in plans] == [(513, 16), (256, 16),
                                             (64, 32)]


def _jax_interpret(q, k, v, kw):
    return np.asarray(jattention.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=64,
        block_k=128, interpret=True, **kw))


@pytest.mark.parametrize("case", DECODE_CASES)
def test_split_decode_mirror_vs_jax_interpret(case):
    q, k, v = _inputs(case, case[4] + 7)
    kw = _kw(case)
    got = ref.attention_split_decode(
        *map(torch.from_numpy, (q, k, v)),
        _ranges(*_plan(case)), **kw)
    np.testing.assert_allclose(got.numpy(), _jax_interpret(q, k, v, kw),
                               atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize("ranges", [
    [(0, 99), (100, 99), (100, 150), (151, 150), (151, 299)],   # empty
    [(0, 6), (7, 13), (14, 299)],                     # uneven splits
    [(0, 0), (1, 1), (2, 299)],                       # single-key splits
])
def test_split_decode_mirror_with_empty_splits(ranges):
    """Rolling cache (negative key positions for the first 53 keys), Tq
    3 with a window (live keys 178 to 299): some splits hold no key, some
    no live key (keys 0 to 150), some none live for a row; the combine
    skips them."""
    case = (1, 6, 2, 3, 300, 32, True, 120, 40.0, 244, -53)
    q, k, v = _inputs(case, 5)
    kw = _kw(case)
    full = ranges + [(r, r - 1) for r in (0, 300)]    # and empty ends
    got = ref.attention_split_decode(*map(torch.from_numpy, (q, k, v)),
                                     full, **kw)
    np.testing.assert_allclose(got.numpy(), _jax_interpret(q, k, v, kw),
                               atol=ATTN_TOL, rtol=ATTN_TOL)


def test_split_decode_mirror_dead_rows_are_zero():
    """A row with no live key in any split gives exactly 0."""
    case = (2, 8, 4, 3, 300, 64, True, None, None, 0, 1)
    q, k, v = map(torch.from_numpy, _inputs(case, 9))
    kw = _kw(case)
    got = ref.attention_split_decode(q, k, v,
                                     _ranges(*_plan(case)),
                                     **kw)
    assert bool((got[:, :, 0] == 0).all())
    torch.testing.assert_close(got, ref.attention_qchunk(q, k, v, **kw),
                               atol=ATTN_TOL, rtol=ATTN_TOL)


def _p_in_bf16(q, k, v, *, block_k, causal, window, softcap):
    """The wgmma route's arithmetic in f32 tensor code: per tile of
    ``block_k`` keys an online softmax, l summing the f32 p, and P
    rounded to bf16 before P V; the output rounded to bf16."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    g = hq // hkv
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    mask = ref.attention_mask(tq, tk, causal=causal, window=window)
    m = torch.full((b, hq, tq), ref.NEG_INF)
    l = torch.zeros((b, hq, tq))
    o = torch.zeros((b, hq, tq, d))
    for t0 in range(0, tk, block_k):
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                         kf[:, :, t0:t0 + block_k]) * d ** -0.5
        s = softcap * torch.tanh(s / softcap)
        s = torch.where(mask[:, t0:t0 + block_k], s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(),
                          vf[:, :, t0:t0 + block_k])
        o = o * alpha[..., None] + pv
        m = m_new
    return (o / torch.where(l > 0, l, 1.0)[..., None]).bfloat16()


@pytest.mark.parametrize("window", [None, 128])
def test_p_rounded_to_bf16_meets_the_bf16_tolerance(window):
    """Reduced gemma2-like shape (GQA 8|4, D 256, softcap 50, 64-key
    tiles as the kernel takes at D 256): P in bf16 stays within 1e-2 of
    the f32 plain version on the same bf16 inputs."""
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .bfloat16() for s in ((1, 8, 320, 256), (1, 4, 320, 256),
                                     (1, 4, 320, 256)))
    kw = dict(causal=True, window=window, softcap=50.0)
    got = _p_in_bf16(q, k, v, block_k=64, **kw)
    want = ref.attention_qchunk(q.float(), k.float(), v.float(), **kw)
    err = (got.float() - want).abs()
    assert bool((err <= BF16_TOL + BF16_TOL * want.abs()).all()), \
        float(err.max())
    assert float(err.max()) > 0     # the rounding is really there
