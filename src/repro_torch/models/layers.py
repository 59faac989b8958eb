"""Layer kinds: attention (``"global"``, ``"local"``, ``"moe"``), RG-LRU,
mLSTM, sLSTM.

Port of ``repro/models/layers.py``:

    init_layer(cfg, kind, gen, device)              -> params
    apply_layer(cfg, kind, p, x, mode, cache, pos)  -> (x, new_cache)
    init_cache(cfg, kind, batch, max_len, device)   -> cache dict

``mode`` in {"train", "prefill", "decode"}: train = full sequence, no
cache; prefill = full sequence, returns a populated decode cache;
decode = one token against the cache at absolute position ``pos`` (a
Python int).  Caches for ``"local"`` layers are rolling buffers of
``window`` entries, newest last, so decode attention runs with
``kv_offset = pos - window + 1`` and negative key positions masked;
the layout is JAX's, so caches carry across the two packages.

Unlike the JAX code, caches are updated in place: prefill and decode
take the layer's cache (``model.prefill`` allocates them with
``init_cache``, global ones at ``max_len``), write the new keys/values
or recurrent state into it and return that same dict.

The mLSTM's prefill runs ``ops.mlstm`` (the ``mlstm_chunkwise``
kernel when served with ``rnn_impl="pallas"``); its train mode runs the
plain chunkwise form, which has a gradient.  JAX's scans become Python
loops.

A ``"moe"`` layer is a global attention layer whose FFN is JAX's
single-device top-k MoE (``_moe_ffn``): sort-based dispatch with a
per-token-block capacity, dropped overflow, (E, cap, D) batched
matmuls.  Its router is f32 in any model dtype.  Under ``axis_rules``
with a mesh whose ``model`` axis divides the experts (and no pod axis)
it runs expert-parallel instead (``_moe_ffn_ep``, JAX's
``_moe_ffn_shardmap``): each rank of the ``model`` group routes its
tokens over the full router table to its own slice of the experts, and
one ``all_reduce`` sums the partial outputs.

Given DTensor parameters and activations (``sharding.distribute_tree``
of ``param_specs``; the dry run and the placed FL step), the layers
restore JAX's ``logical_constraint`` calls (q, k, v on heads and kv,
the FFN's hidden on ffn, each block's output on batch) and run every
computation that is per example and per head or channel on the local
shards (``_lmap``): attention over this rank's heads (or, for a decode
cache split along head_dim, over its slice of head_dim, the scores
summed over the ``model`` group), the RG-LRU scan, the mLSTM and the
sLSTM recurrences.  A moe layer runs ``_moe_ffn_ep``'s local blocks on
the local expert tables.  Plain tensors take none of these branches.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch.kernels import ops, ref
from repro_torch.sharding.api import (axis_rules, axis_sizes, constrain,
                                      current_rules, is_dtensor, local_map,
                                      logical_constraint, model_size,
                                      placements_like)

from .common import (_CopyToGroup, _ReduceFromGroup, causal_conv1d,
                     dense_init, rms_norm, rope, torch_dtype)
from .config import ArchConfig

ATTN_KINDS = ("global", "local", "moe")
RGLRU_C = 8.0          # Griffin's fixed recurrence constant
# ArchConfig keeps the JAX package's impl names.
_IMPL = {"xla": "torch", "pallas": "cuda"}


def _impl(name: str) -> str:
    return _IMPL.get(name, name)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation.
    return torch.nn.functional.gelu(x, approximate="tanh")


def _act(name: str):
    return torch.nn.functional.silu if name == "silu" else _gelu


def checkpointed(fn, *args):
    """``checkpoint(fn, *args)`` (non-reentrant), with the caller's
    ``axis_rules`` binding restored around the recomputation.

    Autograd runs the backward of CUDA tensors, and with it the
    recomputation, on a device thread of its own, where the thread-local
    binding is absent: without it the MoE would choose its route anew
    there (single-device where the forward ran expert-parallel).
    """
    state = current_rules()
    if state is None:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=lambda: (
        contextlib.nullcontext(), axis_rules(*state)))


def _chunked_scan(step, init, xs, *, chunk: int, remat: bool):
    """A scan over time (a Python loop over xs' leading axis) in chunks,
    each checkpointed when ``remat`` is set and grad is enabled.

    Port of ``repro/models/layers.py::_chunked_scan``: backward then
    keeps only the chunk-boundary carries and recomputes inside.
    ``chunk`` shrinks to a divisor of T.  Returns (carry, ys stacked on
    the leading axis).
    """
    def scan(carry, xc):
        ys = []
        for i in range(xc[0].shape[0]):
            carry, y = step(carry, tuple(x[i] for x in xc))
            ys.append(y)
        return carry, torch.stack(ys)

    t = xs[0].shape[0]
    chunk = min(chunk, t)
    while t % chunk:
        chunk -= 1
    nb = t // chunk
    if nb <= 1:
        return scan(init, xs)
    remat = remat and torch.is_grad_enabled()
    carry, ys = init, []
    for c in range(nb):
        xc = tuple(x[c * chunk:(c + 1) * chunk] for x in xs)
        if remat:
            carry, y = checkpointed(scan, carry, xc)
        else:
            carry, y = scan(carry, xc)
        ys.append(y)
    return carry, torch.cat(ys)


def _lmap(like, fn, args, layouts, out_layouts, units: int):
    """``fn`` on the local shards of DTensor ``args`` (``local_map``).

    A layout is ``(batch_dim, unit_dim)``: the batch dim is split as
    ``like``'s dim 0 is, the unit dim (heads, channels) over ``model``
    when ``units`` divide over it, else every ``model`` rank computes
    all of them.  None passes an arg as it is; ``out_layouts`` is one
    layout or a list of them (None for an output left plain).
    """
    split = units % model_size(like) == 0

    def pl(lay):
        if lay is None:
            return None
        return placements_like(like, lay[0], lay[1] if split else None)
    outs = ([pl(o) for o in out_layouts] if isinstance(out_layouts, list)
            else pl(out_layouts))
    return local_map(fn, args, [pl(l) for l in layouts], outs,
                     like.device_mesh)


# ======================================================================
# Attention layers (global / local / moe)
# ======================================================================

def _init_attn(cfg: ArchConfig, kind: str, gen: torch.Generator,
               device=None) -> dict:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    dt = torch_dtype(cfg.dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=device)

    p = {
        "ln1": zeros(d),
        "ln2": zeros(d),
        "wq": dense_init(gen, (d, qd), dt, device=device),
        "wk": dense_init(gen, (d, kvd), dt, device=device),
        "wv": dense_init(gen, (d, kvd), dt, device=device),
        "wo": dense_init(gen, (qd, d), dt, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = zeros(cfg.head_dim)
        p["k_norm"] = zeros(cfg.head_dim)
    if cfg.post_norm:
        p["post_ln1"] = zeros(d)
        p["post_ln2"] = zeros(d)
    if kind == "moe":
        e, fe = cfg.n_experts, cfg.d_expert
        p["router"] = dense_init(gen, (d, e), torch.float32, device=device)
        p["moe_gate"] = dense_init(gen, (e, d, fe), dt, in_axis=1,
                                   device=device)
        p["moe_up"] = dense_init(gen, (e, d, fe), dt, in_axis=1,
                                 device=device)
        p["moe_down"] = dense_init(gen, (e, fe, d), dt, in_axis=1,
                                   device=device)
    else:
        f = cfg.d_ff
        p["w_gate"] = dense_init(gen, (d, f), dt, device=device)
        p["w_up"] = dense_init(gen, (d, f), dt, device=device)
        p["w_down"] = dense_init(gen, (f, d), dt, device=device)
    return p


def _pin(y):
    """A projection's output pinned to (batch, ..., features on
    ``model``), or to the batch split alone where the features do not
    divide over ``model``; its gradient too.  Left alone, DTensor may
    reduce a partial product by scattering it along the sequence, which
    a later reshape cannot follow.  The identity on plain tensors."""
    if not is_dtensor(y):
        return y
    last = y.ndim - 1
    split = y.shape[last] % model_size(y) == 0
    return constrain(y, placements_like(y, 0, last if split else None))


def _branch(y):
    """A residual branch's output pinned to ("batch", "seq", None)
    before it joins the stream.  On DTensors this sums a row-parallel
    projection's partial output over ``model`` (Megatron's reduction),
    where DTensor alone might scatter it along the sequence; on plain
    tensors it is the identity."""
    return logical_constraint(y, "batch", "seq", None)


def _split_heads(y, n: int, dh: int):
    """(B, T, n * dh) -> (B, T, n, dh).  A DTensor whose last dim is
    split over ``model`` into pieces that are not whole heads (n not
    divisible by the axis) is gathered along it first."""
    b, t = y.shape[:2]
    if is_dtensor(y) and n % model_size(y):
        names = tuple(y.device_mesh.mesh_dim_names)
        if not y.placements[names.index("model")].is_replicate():
            y = y.redistribute(y.device_mesh,
                               placements_like(y, 0, None))
    return y.reshape(b, t, n, dh)


def _prefill_cache(window, k, v, cache):
    """Write what prefill leaves into ``cache``: all keys (global), or
    the last ``window`` keys left-padded with zeros (local)."""
    t = k.shape[2]
    for name, src in (("k", k), ("v", v)):
        dst = cache[name]
        if window is not None:
            n = min(t, window)
            dst[:, :, :window - n].zero_()
            dst[:, :, window - n:].copy_(src[:, :, t - n:])
        else:
            dst[:, :, :t].copy_(src)
    return cache


def _attention_mix(cfg: ArchConfig, kind: str, p: dict, h: torch.Tensor,
                   mode: str, cache, pos):
    """Returns (attn_out (B,T,qd), new_cache)."""
    b, t, _ = h.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    window = cfg.window if kind == "local" else None
    impl = _impl(cfg.attn_impl)

    q = _split_heads(_pin(h @ p["wq"]), hq, dh).transpose(1, 2)
    k = _split_heads(_pin(h @ p["wk"]), hkv, dh).transpose(1, 2)
    v = _split_heads(_pin(h @ p["wv"]), hkv, dh).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = logical_constraint(q, "batch", "heads", None, None)
    k = logical_constraint(k, "batch", "kv", None, None)
    v = logical_constraint(v, "batch", "kv", None, None)

    if mode == "decode":
        positions = torch.full((t,), pos, dtype=torch.int32, device=h.device)
    else:
        positions = torch.arange(t, dtype=torch.int32, device=h.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if mode == "decode":
        assert t == 1
        ck, cv = cache["k"], cache["v"]
        if window is not None:                       # rolling buffer
            ck.copy_(torch.cat([ck[:, :, 1:], k.to(ck.dtype)], dim=2))
            cv.copy_(torch.cat([cv[:, :, 1:], v.to(cv.dtype)], dim=2))
            kv_offset = pos - window + 1
        else:
            ck[:, :, pos:pos + 1] = k.to(ck.dtype)
            cv[:, :, pos:pos + 1] = v.to(cv.dtype)
            kv_offset = 0
        new_cache = cache
        out = _attention(
            q, ck, cv, causal=True, window=window,
            softcap=cfg.attn_softcap, q_offset=pos, kv_offset=kv_offset,
            impl=impl, block_q=cfg.block_q, block_k=cfg.block_k)
    else:
        out = _attention(
            q, k, v, causal=cfg.causal, window=window,
            softcap=cfg.attn_softcap, impl=impl, block_q=cfg.block_q,
            block_k=cfg.block_k)
        if mode == "prefill":
            new_cache = _prefill_cache(window, k, v, cache)

    return out @ p["wo"], new_cache


def _attention(q, k, v, **kw):
    """``ops.attention`` with the heads merged: (B, T, Hq * D).  On
    DTensors it runs over this rank's shards, and the heads are merged
    there too (a merge of heads that do not divide over ``model`` is no
    DTensor view).

    Head-parallel where the ``model`` axis divides the query heads: this
    rank's query heads, and its kv heads (sharded too where they divide,
    else sliced from the replicated kv to the heads its queries read).
    A decode cache split along head_dim (too few kv heads,
    ``launch.specs.cache_specs``) runs ``_decode_attention_dh``.  Else
    every ``model`` rank computes all heads.
    """
    if not is_dtensor(q):
        return _merge_heads(ops.attention(q, k, v, **kw))
    tm = q.device_mesh
    names = tuple(tm.mesh_dim_names)
    ms = model_size(q)
    if ms > 1 and is_dtensor(k) and \
            k.placements[names.index("model")].is_shard(3):
        return _decode_attention_dh(q, k, v, **kw)
    hq, hkv = q.shape[1], k.shape[1]
    group = hq // hkv
    hq_loc = hq // ms
    split_q = ms > 1 and hq % ms == 0 and (
        hkv % ms == 0 or hq_loc % group == 0 or group % hq_loc == 0)
    split_kv = split_q and hkv % ms == 0
    r = tm.get_local_rank("model") if split_q else 0

    def fn(ql, kl, vl):
        if split_q and not split_kv:
            lo = (r * hq_loc) // group
            n = max(1, hq_loc // group)
            kl, vl = kl[:, lo:lo + n], vl[:, lo:lo + n]
        return _merge_heads(ops.attention(ql, kl, vl, **kw))
    q_pl = placements_like(q, 0, 1 if split_q else None)
    kv_pl = placements_like(q, 0, 1 if split_kv else None)
    return local_map(fn, (q, k, v), (q_pl, kv_pl, kv_pl),
                     placements_like(q, 0, 2 if split_q else None), tm)


def _merge_heads(o):
    """(B, H, T, D) -> (B, T, H * D)."""
    b, h, t, d = o.shape
    return o.transpose(1, 2).reshape(b, t, h * d)


@torch.no_grad()
def _decode_attention_dh(q, k, v, *, causal, window, softcap, q_offset,
                         kv_offset, scale=None, **_):
    """Decode attention over a cache split along head_dim on ``model``.

    Each rank contracts its slice of head_dim (q is split to match), the
    scores are summed over the ``model`` group, and each rank forms its
    slice of the output (then laid out by heads and merged): what GSPMD
    does with a contracted sharded dim.
    The plain attention's math (``ref.attention_qchunk``): f32 scores,
    softcap, mask, softmax, zero rows with no live key.
    """
    tm = q.device_mesh
    grp = tm.get_group("model")
    d = q.shape[-1]
    sc = (d ** -0.5) if scale is None else scale

    def fn(ql, kl, vl):
        b, hq, tq, dl = ql.shape
        hkv, tk = kl.shape[1], kl.shape[2]
        qg = ql.float().reshape(b, hkv, hq // hkv, tq, dl)
        s = torch.einsum("bkgqd,bktd->bkgqt", qg, kl.float())
        dist.all_reduce(s, group=grp)
        s = s * sc
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        mask = ref.attention_mask(tq, tk, causal=causal, window=window,
                                  q_offset=q_offset, kv_offset=kv_offset,
                                  device=ql.device)
        s = torch.where(mask, s, ref.NEG_INF)
        pr = torch.softmax(s, dim=-1)
        pr = torch.where(mask.any(-1)[:, None], pr, 0.0)
        o = torch.einsum("bkgqt,bktd->bkgqd", pr, vl.float())
        return o.reshape(b, hq, tq, dl).to(ql.dtype)
    pl = placements_like(q, 0, 3)
    out = local_map(fn, (q, k, v), (pl, pl, pl), pl, tm)
    # back to heads (the output projection's rows), then merged
    split = q.shape[1] % model_size(q) == 0
    out = out.redistribute(tm, placements_like(q, 0, 1 if split else None))
    return local_map(_merge_heads, (out,), (out.placements,),
                     placements_like(q, 0, 2 if split else None), tm)


def _dense_ffn(cfg: ArchConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    g = _act(cfg.act)(_pin(h @ p["w_gate"])) * _pin(h @ p["w_up"])
    g = logical_constraint(g, "batch", None, "ffn")
    return g @ p["w_down"]


MOE_TOKEN_BLOCK = 8192


def _moe_ffn_ep(cfg: ArchConfig, p: dict, h: torch.Tensor, mesh):
    """Expert-parallel MoE over the mesh's ``model`` group.

    Port of ``repro/models/layers.py::_moe_ffn_shardmap``.  The tokens
    are this rank's (the FL step has already split the batch over the
    ``data`` axis, where the JAX body takes its ``data`` shard), the
    same on every rank of the ``model`` group.  Each rank routes them
    over the full router table, keeps the assignments to its own
    ``n_experts / model`` experts (``_moe_local_block``; capacity from
    the local token count and the global expert count), and one
    ``all_reduce`` sums the partial outputs.  The tokens, the router and
    the expert tables enter through ``_CopyToGroup``, so their
    gradients are the sums over the group: the single-device ones, on
    every rank (the tables are plain, replicated tensors here; placed
    tables take ``_moe_ffn_dtensor``).

    Returns None where the JAX package falls back to ``_moe_ffn``'s
    blocked path: no ``model`` axis larger than 1, experts not divisible
    by it, or a pod axis.
    """
    sizes = axis_sizes(mesh)
    ms = int(sizes.get("model", 1))
    if ms <= 1 or cfg.n_experts % ms or int(sizes.get("pod", 1)) > 1:
        return None
    group, g_id = mesh.groups["model"], mesh.coords["model"]
    b, t, d = h.shape
    e_loc = cfg.n_experts // ms
    mine = slice(g_id * e_loc, (g_id + 1) * e_loc)
    x = _CopyToGroup.apply(h.reshape(b * t, d), group)
    router = _CopyToGroup.apply(p["router"], group)
    wg, wu, wd = (_CopyToGroup.apply(p[k], group)[mine]
                  for k in ("moe_gate", "moe_up", "moe_down"))
    y = _moe_local_block(cfg, x, router, wg, wu, wd, g_id)
    return _ReduceFromGroup.apply(y, group).reshape(b, t, d)


def _moe_local_block(cfg: ArchConfig, x_loc, router, wg, wu, wd,
                     g_id: int) -> torch.Tensor:
    """Route local tokens to the local expert slice (sort-based).

    Port of ``repro/models/layers.py::_moe_local_block``.  x_loc: (n,
    D); router: the full (D, E) table; wg, wu, wd: experts ``g_id *
    e_loc`` to ``(g_id + 1) * e_loc - 1``.  The top-k over all E
    experts picks each token's assignments; those to other slices go
    to a sink past the local experts; each expert's first ``cap``
    assignments, in token order, are kept and the rest dropped.
    Returns the local experts' share of the (n, D) output: summed over
    the ``E / e_loc`` slices it is the output of all E experts (one
    slice of all E is ``_moe_ffn_block``).
    """
    n, d = x_loc.shape
    e, k_top = cfg.n_experts, cfg.top_k
    e_loc = wg.shape[0]
    dev = x_loc.device
    # the routing and dispatch: a host-timed region (the checkpointed
    # recompute records it again, inside the backward)
    with obs.get().region("moe.route"):
        probs = torch.softmax(x_loc.float() @ router, dim=-1)
        gates, idx = _top_k(probs, k_top)                 # full table
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

        rel = idx - g_id * e_loc                          # (n, k)
        inb = (rel >= 0) & (rel < e_loc)
        flat_e = torch.where(inb, rel, e_loc).reshape(-1)
        order = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        # each expert's first slot in the sorted order (a bincount's
        # exclusive cumsum, without the host sync of a CUDA bincount)
        starts = torch.searchsorted(
            sorted_e, torch.arange(e_loc + 1, dtype=flat_e.dtype,
                                   device=dev))
        pos_in_e = torch.arange(n * k_top, device=dev) - starts[sorted_e]
        cap = math.ceil(n * k_top / e * cfg.capacity_factor)
        cap = max(8, -(-cap // 8) * 8)
        keep = (pos_in_e < cap) & (sorted_e < e_loc)
        dest = torch.where(keep, sorted_e * cap + pos_in_e, e_loc * cap)
        src_token = order // k_top

        buf = torch.zeros((e_loc * cap + 1, d), dtype=x_loc.dtype,
                          device=dev)
        buf = buf.index_put((dest,), x_loc[src_token])
    buf = buf[:-1].reshape(e_loc, cap, d)
    buf = logical_constraint(buf, "expert", None, None)
    g = torch.bmm(buf, wg)
    u = torch.bmm(buf, wu)
    y = torch.bmm(_act(cfg.act)(g) * u, wd)
    y = logical_constraint(y, "expert", None, None)
    y = torch.cat([y.reshape(e_loc * cap, d),
                   torch.zeros((1, d), dtype=x_loc.dtype, device=dev)])
    slot = torch.empty_like(dest).scatter_(0, order, dest)
    yk = y[slot].reshape(n, k_top, d)
    w = (gates * inb.to(gates.dtype)).to(x_loc.dtype)
    return (w[..., None] * yk).sum(dim=1)


def _moe_ffn(cfg: ArchConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    """Top-k MoE FFN, processed in token blocks.

    Port of ``repro/models/layers.py::_moe_ffn``.  Under ``axis_rules``
    with a mesh it first tries the expert-parallel path
    (``_moe_ffn_ep``).  Otherwise the B*T tokens are cut into blocks of MOE_TOKEN_BLOCK (halved until
    it divides them; one block when it reaches B*T or falls under 64),
    each routed on its own with its own capacity, so the blocking is
    part of the function: it decides which assignments are dropped.
    With grad enabled each block is checkpointed (non-reentrant), as
    JAX's ``jax.checkpoint`` over ``lax.map``, so the capacity buffers
    of one block at a time are live.
    """
    if is_dtensor(p["moe_gate"]):
        return _moe_ffn_dtensor(cfg, p, h)
    state = current_rules()
    if state is not None and state[1] is not None:
        out = _moe_ffn_ep(cfg, p, h, state[1])
        if out is not None:
            return out
    b, t, d = h.shape
    n = b * t
    xf = h.reshape(n, d)
    block = MOE_TOKEN_BLOCK
    while n % block:
        block //= 2
    if block >= n or block < 64:
        return _moe_ffn_block(cfg, p, xf).reshape(b, t, d)

    def fn(xb):
        return _moe_ffn_block(cfg, p, xb)

    remat = torch.is_grad_enabled()
    out = [checkpointed(fn, xb) if remat else fn(xb)
           for xb in xf.split(block)]
    return torch.cat(out).reshape(b, t, d)


def _moe_ffn_dtensor(cfg: ArchConfig, p: dict, h) -> torch.Tensor:
    """The MoE FFN over DTensors: ``_moe_ffn_ep``'s local blocks.

    Each rank routes its batch shard's tokens over the full router
    table to its own ``n_experts / model`` experts (the expert tables
    gathered along any ZeRO split first, as FSDP gathers them), and the
    partial outputs are summed over the ``model`` group.  Where the
    ``model`` axis does not divide the experts every rank runs all of
    them.  Gradients take ``Partial`` placements where ranks saw
    different tokens or experts, so DTensor reduces them.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    tm = h.device_mesh
    names = tuple(tm.mesh_dim_names)
    ms = model_size(h)
    ep = ms > 1 and cfg.n_experts % ms == 0
    b, t, d = h.shape
    batch = placements_like(h, 0, None)
    split = [pl == Shard(0) for pl in batch]

    def grads(on_model):
        return tuple(on_model if n == "model" else
                     Partial() if sp else Replicate()
                     for n, sp in zip(names, split))
    part = Partial() if ep else Replicate()
    xl = h.redistribute(tm, batch).to_local(
        grad_placements=tuple(part if n == "model" else pl
                              for n, pl in zip(names, batch)))
    router = p["router"].redistribute(tm, (Replicate(),) * tm.ndim)
    router = router.to_local(grad_placements=grads(part))
    w_pl = tuple(Shard(0) if (n == "model" and ep) else Replicate()
                 for n in names)
    ws = [p[k].redistribute(tm, w_pl).to_local(
        grad_placements=grads(w_pl[names.index("model")]
                              if "model" in names else Replicate()))
          for k in ("moe_gate", "moe_up", "moe_down")]
    g_id = tm.get_local_rank("model") if ep else 0
    y = _moe_local_block(cfg, xl.reshape(-1, d), router, *ws, g_id)
    out_pl = tuple(part if n == "model" else pl
                   for n, pl in zip(names, batch))
    y = DTensor.from_local(y.reshape(xl.shape), tm, out_pl,
                           run_check=False)
    return y.redistribute(tm, batch)


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values and
    their indices, equal values in index order (``torch.topk`` promises
    no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_ffn_block(cfg: ArchConfig, p: dict, xf: torch.Tensor
                   ) -> torch.Tensor:
    """Sort-based top-k expert routing with capacity (drop overflow).

    Port of ``repro/models/layers.py::_moe_ffn_block``.  xf: (n, D).
    ``_moe_local_block`` over all the experts (one slice): the f32
    router picks each token's top-k experts; the n*k assignments,
    stably sorted by expert, take slots 0..cap-1 of their expert in
    token order, and those past ``cap`` go to a sink row that is
    dropped.  Returns (n, D) in xf's dtype.
    """
    return _moe_local_block(cfg, xf, p["router"], p["moe_gate"],
                            p["moe_up"], p["moe_down"], 0)


def _apply_attn(cfg: ArchConfig, kind: str, p: dict, x: torch.Tensor,
                mode: str, cache, pos):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    attn, new_cache = _attention_mix(cfg, kind, p, h, mode, cache, pos)
    if cfg.post_norm:
        attn = rms_norm(attn, p["post_ln1"], cfg.norm_eps)
    x = x + _branch(attn)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    ff = _moe_ffn(cfg, p, h) if kind == "moe" else _dense_ffn(cfg, p, h)
    if cfg.post_norm:
        ff = rms_norm(ff, p["post_ln2"], cfg.norm_eps)
    x = logical_constraint(x + _branch(ff), "batch", "seq", None)
    return x, new_cache


# ======================================================================
# RG-LRU (Griffin recurrent block + GeGLU FFN)
# ======================================================================

def _init_rglru(cfg: ArchConfig, gen: torch.Generator, device=None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dr = cfg.d_rnn or d
    dt = torch_dtype(cfg.dtype)
    # Lambda init so a = exp(-c * softplus(lam)) ~ U(0.9, 0.999) at r=1.
    u = 0.9 + 0.099 * torch.rand((dr,), generator=gen, dtype=torch.float32,
                                 device=device)
    lam = torch.log(torch.expm1(-torch.log(u) / RGLRU_C))
    conv_w = torch.randn((cfg.conv_width, dr), generator=gen,
                         dtype=torch.float32, device=device)
    return {
        "ln1": torch.zeros((d,), dtype=dt, device=device),
        "ln2": torch.zeros((d,), dtype=dt, device=device),
        "rg_in": dense_init(gen, (d, dr), dt, device=device),
        "rg_gate": dense_init(gen, (d, dr), dt, device=device),
        "conv_w": (conv_w * cfg.conv_width ** -0.5).to(dt),
        "lam": lam,
        "a_gate_w": torch.ones((dr,), dtype=torch.float32, device=device),
        "i_gate_w": torch.ones((dr,), dtype=torch.float32, device=device),
        "rg_out": dense_init(gen, (dr, d), dt, device=device),
        "w_gate": dense_init(gen, (d, f), dt, device=device),
        "w_up": dense_init(gen, (d, f), dt, device=device),
        "w_down": dense_init(gen, (f, d), dt, device=device),
    }


def _apply_rglru(cfg: ArchConfig, p: dict, x: torch.Tensor, mode: str,
                 cache, pos):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    xr = _pin(h @ p["rg_in"])
    xg = _gelu(_pin(h @ p["rg_gate"]))
    conv_state = cache["conv"] if mode == "decode" else None
    xc, new_conv = causal_conv1d(xr, p["conv_w"], conv_state)

    xcf = xc.float()
    r = torch.sigmoid(xcf * p["a_gate_w"])
    i = torch.sigmoid(xcf * p["i_gate_w"])
    # jax.nn.softplus is logaddexp(x, 0)
    softplus = torch.logaddexp(p["lam"], torch.zeros_like(p["lam"]))
    a = torch.exp(-RGLRU_C * softplus * r)
    h0 = cache["h"] if mode == "decode" else None
    impl = _impl(cfg.rnn_impl)
    args = (xc, a.to(xc.dtype), i.to(xc.dtype), h0)
    if is_dtensor(xc):
        y, h_t = _lmap(xc, lambda *t: ops.rglru(*t, impl=impl), args,
                       [(0, 2)] * 3 + [(0, 1)], [(0, 2), (0, 1)],
                       xc.shape[2])
    else:
        y, h_t = ops.rglru(*args, impl=impl)
    x = x + _branch((xg * y) @ p["rg_out"])
    hh = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + _branch(_dense_ffn(cfg, p, hh))
    if mode in ("decode", "prefill"):
        cache["h"].copy_(h_t)
        cache["conv"].copy_(new_conv)
    return x, cache


# ======================================================================
# mLSTM (xLSTM matrix-memory block)
# ======================================================================

MLSTM_CHUNK = 128


def _init_mlstm(cfg: ArchConfig, gen: torch.Generator, device=None) -> dict:
    d = cfg.d_model
    di = 2 * d
    dt = torch_dtype(cfg.dtype)
    f32 = torch.float32
    conv_w = torch.randn((cfg.conv_width, di), generator=gen, dtype=f32,
                         device=device)
    return {
        "norm": torch.zeros((d,), dtype=dt, device=device),
        "up_l": dense_init(gen, (d, di), dt, device=device),
        "up_r": dense_init(gen, (d, di), dt, device=device),
        "conv_w": (conv_w * cfg.conv_width ** -0.5).to(dt),
        "wq_i": dense_init(gen, (di, di), dt, device=device),
        "wk_i": dense_init(gen, (di, di), dt, device=device),
        "wv_i": dense_init(gen, (di, di), dt, device=device),
        "wi": dense_init(gen, (di, cfg.rnn_heads), f32, device=device),
        "wf": dense_init(gen, (di, cfg.rnn_heads), f32, device=device),
        "wo_gate": dense_init(gen, (di, di), dt, device=device),
        "down": dense_init(gen, (di, d), dt, device=device),
    }


def _mlstm_prefill(cfg: ArchConfig, q, k, v, i_pre, f_pre):
    """The chunkwise mLSTM from a zero state through ``ops.mlstm``.

    The chunk is min(MLSTM_CHUNK, T) and T is padded here to a multiple
    of it with inert steps, as ``_mlstm_chunkwise`` pads, so the kernel
    runs for any prompt length.  It gets transposed views of the
    (B, T, H, dh) tensors and reads them through strides.  Returns
    (state, h (B, T, H, dh)).
    """
    t = q.shape[1]
    chunk = min(MLSTM_CHUNK, t)
    q, k, v, i_pre, f_pre = ref.mlstm_pad(q, k, v, i_pre, f_pre, chunk)
    h, C, n, m = ops.mlstm(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), i_pre.transpose(1, 2),
                           f_pre.transpose(1, 2), chunk=chunk,
                           impl=_impl(cfg.rnn_impl))
    return (C, n, m), h.transpose(1, 2)[:, :t]


def _apply_mlstm(cfg: ArchConfig, p: dict, x: torch.Tensor, mode: str,
                 cache, pos):
    b, t, d = x.shape
    di = 2 * d
    hh = cfg.rnn_heads
    dh = di // hh
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    xl = _pin(h @ p["up_l"])
    # The JAX layer also computes silu(h @ up_r) and never uses it (XLA
    # drops it); the port skips the product.  up_r's gradient is zero in
    # both packages.
    conv_state = cache["conv"] if mode == "decode" else None
    xc, new_conv = causal_conv1d(xl, p["conv_w"], conv_state)

    scale = dh ** -0.5
    q = _split_heads(_pin(xc @ p["wq_i"]), hh, dh).float() * scale
    k = _split_heads(_pin(xc @ p["wk_i"]), hh, dh).float() * scale
    v = _split_heads(_pin(xl @ p["wv_i"]), hh, dh).float()
    i_pre = _pin(xc.float() @ p["wi"])                     # (B,T,H)
    f_pre = _pin(xc.float() @ p["wf"]) + 1.0
    o = torch.sigmoid(_pin(xc @ p["wo_gate"]))

    def core(q, k, v, i_pre, f_pre, *state):
        """The recurrence on (local) heads; h merged to (B, T, H*dh)."""
        bl, tl = q.shape[:2]
        if mode == "decode":
            state, hs = ref.mlstm_step(
                state, (q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0],
                        f_pre[:, 0]))
            return (*state, hs.reshape(bl, 1, -1))
        if mode == "prefill":
            state, hs = _mlstm_prefill(cfg, q, k, v, i_pre, f_pre)
        else:
            state, hs = ref.mlstm_chunkwise_torch(
                q, k, v, i_pre, f_pre,
                ref.mlstm_zero_state(bl, q.shape[2], dh, q.device),
                chunk=MLSTM_CHUNK, remat=True)
        return (*state, hs.reshape(bl, tl, -1))

    args = (q, k, v, i_pre, f_pre)
    if mode == "decode":
        args += (cache["C"], cache["n"], cache["m"])
    if is_dtensor(q):
        *state, hs = _lmap(q, core, args, [(0, 2)] * 5 + [(0, 1)] * 3,
                           [(0, 1)] * 3 + [(0, 2)], hh)
    else:
        *state, hs = core(*args)

    y = (o * hs.to(o.dtype)) @ p["down"]
    x = x + _branch(y)
    if mode in ("decode", "prefill"):
        for name, new in zip(("C", "n", "m"), state):
            cache[name].copy_(new)
        cache["conv"].copy_(new_conv)
    return x, cache


# ======================================================================
# sLSTM (xLSTM scalar-memory block)
# ======================================================================

def _init_slstm(cfg: ArchConfig, gen: torch.Generator, device=None) -> dict:
    d = cfg.d_model
    hh = cfg.rnn_heads
    dh = d // hh
    f = -(-4 * d // 3 // 128) * 128
    dt = torch_dtype(cfg.dtype)
    f32 = torch.float32
    r4 = torch.randn((hh, dh, 4 * dh), generator=gen, dtype=f32,
                     device=device)
    return {
        "norm": torch.zeros((d,), dtype=dt, device=device),
        "ln2": torch.zeros((d,), dtype=dt, device=device),
        "w4": dense_init(gen, (d, 4 * d), f32, device=device),
        "r4": r4 * dh ** -0.5,
        "b4": torch.zeros((hh, 4 * dh), dtype=f32, device=device),
        "w_gate": dense_init(gen, (d, f), dt, device=device),
        "w_up": dense_init(gen, (d, f), dt, device=device),
        "w_down": dense_init(gen, (f, d), dt, device=device),
    }


def _slstm_step(p, state, wx_t):
    """wx_t: (B, H, 4*dh) input pre-activations for one step."""
    c, n, hprev, m = state
    gates = wx_t + torch.einsum("bhd,hde->bhe", hprev, p["r4"]) + p["b4"]
    dh = c.shape[-1]
    i_pre = gates[..., 0 * dh:1 * dh]
    f_pre = gates[..., 1 * dh:2 * dh] + 1.0
    z_pre = gates[..., 2 * dh:3 * dh]
    o_pre = gates[..., 3 * dh:4 * dh]
    m_new = torch.maximum(f_pre + m, i_pre)
    ii = torch.exp(i_pre - m_new)
    ff = torch.exp(f_pre + m - m_new)
    c = ff * c + ii * torch.tanh(z_pre)
    n = ff * n + ii
    h = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1.0)
    return (c, n, h, m_new), h


def _apply_slstm(cfg: ArchConfig, p: dict, x: torch.Tensor, mode: str,
                 cache, pos):
    b, t, d = x.shape
    hh = cfg.rnn_heads
    dh = d // hh
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    wx = _split_heads(_pin(h.float() @ p["w4"]), hh, 4 * dh)

    def core(wx, r4, b4, *state):
        pr = {"r4": r4, "b4": b4}
        if mode == "decode":
            state, hs = _slstm_step(pr, state, wx[:, 0])
            return (*state, hs.reshape(hs.shape[0], 1, -1))
        bl, hl = wx.shape[0], wx.shape[2]
        zeros = torch.zeros((bl, hl, dh), dtype=torch.float32,
                            device=wx.device)
        init = (zeros, zeros, zeros,
                torch.full((bl, hl, dh), ref.NEG_INF, dtype=torch.float32,
                           device=wx.device))
        state, hs = _chunked_scan(
            lambda s, w: _slstm_step(pr, s, w[0]), init,
            (wx.transpose(0, 1),), chunk=256, remat=(mode == "train"))
        return (*state, hs.transpose(0, 1).reshape(bl, wx.shape[1], -1))

    args = (wx, p["r4"], p["b4"])
    if mode == "decode":
        args += (cache["c"], cache["n"], cache["h"], cache["m"])
    if is_dtensor(wx):
        *state, hs = _lmap(wx, core, args,
                           [(0, 2), (None, 0), (None, 0)] + [(0, 1)] * 4,
                           [(0, 1)] * 4 + [(0, 2)], hh)
    else:
        *state, hs = core(*args)
    y = hs.to(x.dtype)
    x = x + _branch(y)
    hh2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + _branch(_dense_ffn(cfg, p, hh2))
    if mode in ("decode", "prefill"):
        for name, new in zip(("c", "n", "h", "m"), state):
            cache[name].copy_(new)
    return x, cache


# ======================================================================
# Dispatch
# ======================================================================

def init_layer(cfg: ArchConfig, kind: str, gen: torch.Generator,
               device=None) -> dict:
    if kind in ATTN_KINDS:
        return _init_attn(cfg, kind, gen, device)
    if kind == "rglru":
        return _init_rglru(cfg, gen, device)
    if kind == "mlstm":
        return _init_mlstm(cfg, gen, device)
    if kind == "slstm":
        return _init_slstm(cfg, gen, device)
    raise ValueError(kind)


def apply_layer(cfg: ArchConfig, kind: str, p: dict, x: torch.Tensor,
                mode: str = "train", cache=None, pos=None):
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    if kind in ATTN_KINDS:
        return _apply_attn(cfg, kind, p, x, mode, cache, pos)
    if kind == "rglru":
        return _apply_rglru(cfg, p, x, mode, cache, pos)
    if kind == "mlstm":
        return _apply_mlstm(cfg, p, x, mode, cache, pos)
    if kind == "slstm":
        return _apply_slstm(cfg, p, x, mode, cache, pos)
    raise ValueError(kind)


def init_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
               dtype=None, device=None) -> dict:
    """Zeroed decode cache of one layer, as ``repro`` lays it out."""
    dt = dtype or torch_dtype(cfg.dtype)
    if kind in ATTN_KINDS:
        cdt = dtype or torch_dtype(cfg.cache_dtype or cfg.dtype)
        size = cfg.window if kind == "local" else max_len
        shape = (batch, cfg.n_kv, size, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=cdt, device=device),
                "v": torch.zeros(shape, dtype=cdt, device=device)}
    if kind == "rglru":
        dr = cfg.d_rnn or cfg.d_model
        return {"h": torch.zeros((batch, dr), dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros((batch, cfg.conv_width - 1, dr),
                                    dtype=dt, device=device)}
    if kind == "mlstm":
        di = 2 * cfg.d_model
        C, n, m = ref.mlstm_zero_state(batch, cfg.rnn_heads,
                                       di // cfg.rnn_heads, device)
        return {"C": C, "n": n, "m": m,
                "conv": torch.zeros((batch, cfg.conv_width - 1, di),
                                    dtype=dt, device=device)}
    f32 = dict(dtype=torch.float32, device=device)
    if kind == "slstm":
        hh = cfg.rnn_heads
        dh = cfg.d_model // hh
        return {"c": torch.zeros((batch, hh, dh), **f32),
                "n": torch.zeros((batch, hh, dh), **f32),
                "h": torch.zeros((batch, hh, dh), **f32),
                "m": torch.full((batch, hh, dh), ref.NEG_INF, **f32)}
    raise ValueError(kind)
