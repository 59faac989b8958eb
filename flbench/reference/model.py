"""Plain f32 reference of a top-k MoE transformer's loss and gradients.

Written from the architecture's equations, with nothing of the program
under test imported: pre-norm blocks of RMSNorm (scale ``1 + w``),
grouped-query causal attention with half-split RoPE and optional
per-head qk-norm, and a top-k mixture of SwiGLU experts with a router
in f32; a final RMSNorm and a tied or untied head; mean next-token
cross-entropy.

The MoE keeps the capacity rule that decides which assignments are
dropped: the tokens are cut into blocks (8192 tokens, halved until the
block divides the batch's tokens; one block when it reaches them or
falls under 64), each block routes on its own, each token takes its
top-k experts by the softmax of the router (ties to the lower index),
the k gates renormalised to sum 1; an expert takes
``cap = max(8, ceil(ceil(n * k / E * capacity_factor) / 8) * 8)``
assignments of a block in token order (a token's k choices in rank
order) and drops the rest.

Parameters are the tree the benchmark hands both sides, with f32
leaves: ``embed`` (V, D), ``head`` (D, V) when untied, ``final_norm``
(D,), and ``cycles/slot0/<name>`` stacked over the layers: ``ln1``,
``ln2`` (D,), ``wq`` (D, H*dh), ``wk``, ``wv`` (D, Hkv*dh), ``wo``
(H*dh, D), ``q_norm``, ``k_norm`` (dh,) with qk-norm, ``router`` (D,
E), ``moe_gate``, ``moe_up`` (E, D, F), ``moe_down`` (E, F, D).

``precision`` sets how the products of the linear layers and of
attention (not the router's) are computed: ``"f32"`` in f32; ``"fp8"``
as fp8 training computes them, the control that a lower precision than
the configuration's bfloat16 must fail: the forward's operands rounded
to float8 e4m3 and the backward's incoming gradient to float8 e5m2,
each with one scale a tensor (its amax over the format's largest
value), the products accumulated in f32.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

TOKEN_BLOCK = 8192


def _round(x: torch.Tensor, fmt) -> torch.Tensor:
    """x rounded to the float8 format ``fmt`` under one scale."""
    s = x.abs().amax().clamp(min=1e-30) / torch.finfo(fmt).max
    return (x / s).to(fmt).to(torch.float32) * s


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` (a (..., K), b (K, N) or batched like a) computed as fp8
    training does."""

    @staticmethod
    def forward(ctx, a, b):
        qa = _round(a, torch.float8_e4m3fn)
        qb = _round(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _round(g, torch.float8_e5m2)
        ga = qg @ qb.transpose(-1, -2)
        if qb.dim() == 2:
            gb = qa.reshape(-1, qa.shape[-1]).T @ qg.reshape(-1,
                                                             qg.shape[-1])
        else:                       # batched (attention's products)
            gb = qa.transpose(-1, -2) @ qg
        return ga, gb


def linear_fn(precision: str):
    """``a @ b`` computed as ``precision`` says."""
    if precision == "f32":
        return torch.matmul
    if precision == "fp8":
        return _Fp8Matmul.apply
    raise ValueError(f"unknown precision {precision!r}")


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x, theta):
    """x (B, H, T, dh): rotate the two halves of each head by position."""
    t, dh = x.shape[2], x.shape[3]
    half = dh // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * freq[None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def attention(cfg, lp, h, mm):
    b, t, _ = h.shape
    hq, hkv, dh = cfg["n_heads"], cfg["n_kv"], cfg["head_dim"]
    q = mm(h, lp["wq"]).reshape(b, t, hq, dh).transpose(1, 2)
    k = mm(h, lp["wk"]).reshape(b, t, hkv, dh).transpose(1, 2)
    v = mm(h, lp["wv"]).reshape(b, t, hkv, dh).transpose(1, 2)
    if cfg["qk_norm"]:
        q = rms_norm(q, lp["q_norm"], cfg["norm_eps"])
        k = rms_norm(k, lp["k_norm"], cfg["norm_eps"])
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    # query head j reads kv head j // (hq // hkv)
    k = k.repeat_interleave(hq // hkv, dim=1)
    v = v.repeat_interleave(hq // hkv, dim=1)
    s = mm(q, k.transpose(-1, -2)) * dh ** -0.5
    causal = torch.ones(t, t, dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = mm(torch.softmax(s, dim=-1), v)
    return mm(o.transpose(1, 2).reshape(b, t, hq * dh), lp["wo"])


def token_block(n: int) -> int:
    block = TOKEN_BLOCK
    while n % block:
        block //= 2
    return n if (block >= n or block < 64) else block


def moe_block(cfg, lp, x, mm):
    """One routing block: x (n, D) -> (n, D)."""
    n, _ = x.shape
    e, k = cfg["n_experts"], cfg["top_k"]
    probs = torch.softmax(x @ lp["router"], dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    cap = math.ceil(n * k / e * cfg["capacity_factor"])
    cap = max(8, -(-cap // 8) * 8)
    choice = idx.reshape(-1)                           # token-major
    onehot = torch.nn.functional.one_hot(choice, e)
    rank = (onehot.cumsum(0) - 1).gather(1, choice[:, None])[:, 0]
    kept = (rank < cap).reshape(n, k)
    out = torch.zeros_like(x)
    for j in range(e):
        tok, slot = torch.nonzero((idx == j) & kept, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        g = mm(xe, lp["moe_gate"][j])
        u = mm(xe, lp["moe_up"][j])
        y = mm(torch.nn.functional.silu(g) * u, lp["moe_down"][j])
        out = out.index_add(0, tok, gates[tok, slot][:, None] * y)
    return out


def layer(cfg, lp, x, mm):
    eps = cfg["norm_eps"]
    x = x + attention(cfg, lp, rms_norm(x, lp["ln1"], eps), mm)
    h = rms_norm(x, lp["ln2"], eps)
    b, t, d = h.shape
    hf = h.reshape(b * t, d)
    blk = token_block(b * t)
    y = torch.cat([moe_block(cfg, lp, hb, mm) for hb in hf.split(blk)])
    return x + y.reshape(b, t, d)


def loss_sum(cfg, p, tokens, labels, mm):
    """Sum over the rows' tokens of the next-token cross-entropy."""
    if list(cfg["pattern"]) != ["moe"]:
        raise ValueError("the reference models the 'moe' pattern only")
    d = cfg["d_model"]
    x = p["embed"][tokens] * math.sqrt(d)
    slot = p["cycles"]["slot0"]
    for i in range(cfg["n_layers"]):
        lp = {name: w[i] for name, w in slot.items()}
        x = checkpoint(layer, cfg, lp, x, mm, use_reentrant=False)
    x = rms_norm(x, p["final_norm"], cfg["norm_eps"])
    head = p["embed"].T if cfg["tie_embeddings"] else p["head"]
    total = x.new_zeros(())
    for xc, yc in zip(x.split(512, dim=1), labels.split(512, dim=1)):
        logits = mm(xc, head)
        total = total + torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), yc.reshape(-1),
            reduction="sum")
    return total


def loss_and_grad(cfg, p, tokens, labels, precision: str = "f32"):
    """Mean loss over all tokens of the batch and its gradient (a tree
    like ``p``).  Rows go through in groups that hold whole routing
    blocks, so the capacity rule sees the blocks the whole batch has."""
    mm = linear_fn(precision)
    b, t = tokens.shape
    rows = max(1, token_block(b * t) // t)
    if token_block(b * t) % t:
        rows = b
    leaves, rebuild = flatten(p)
    req = [w.detach().requires_grad_(True) for w in leaves]
    grads = [torch.zeros_like(w) for w in leaves]
    total = 0.0
    for r in range(0, b, rows):
        s = loss_sum(cfg, rebuild(req), tokens[r:r + rows],
                     labels[r:r + rows], mm) / (b * t)
        gs = torch.autograd.grad(s, req, allow_unused=True)
        for acc, g in zip(grads, gs):
            if g is not None:
                acc.add_(g)
        total += float(s.detach())
    return total, rebuild(grads)


def flatten(tree):
    """Leaves in sorted-key order, and a function that rebuilds a tree
    of the same shape from such a list."""
    order = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, c in enumerate(node):
                walk(c, path + (i,))
        else:
            order.append((path, node))

    walk(tree, ())

    def rebuild(vals):
        out = _skeleton(tree)
        for (path, _), v in zip(order, vals):
            node = out
            for key in path[:-1]:
                node = node[key]
            node[path[-1]] = v
        return out

    return [v for _, v in order], rebuild


def _skeleton(node):
    if isinstance(node, dict):
        return {k: _skeleton(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_skeleton(c) for c in node]
    return None


def leaves(tree):
    return flatten(tree)[0]
