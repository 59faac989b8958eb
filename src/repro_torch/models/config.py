"""Architecture configuration shared by all 10 assigned archs.

A copy of ``repro/models/config.py``: the same fields and defaults, so
a configuration compares equal field by field across the two packages.

One ``ArchConfig`` fully determines parameter shapes, layer pattern and
runtime behaviour.  Layer *kinds* (the ``pattern`` cycle):

* ``"global"``  — full causal (or bidirectional) attention + dense FFN
* ``"local"``   — sliding-window attention + dense FFN
* ``"moe"``     — full attention + top-k MoE FFN
* ``"rglru"``   — Griffin recurrent block (conv + RG-LRU), GeGLU FFN
* ``"mlstm"``   — xLSTM matrix-LSTM block (self-contained, no FFN)
* ``"slstm"``   — xLSTM scalar-LSTM block (post-up FFN inside block)

``n_layers = n_cycles * len(pattern) + tail``; the tail reuses the first
``tail`` kinds of the pattern (e.g. gemma3's 34 = 5*6 + 4).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: tuple[str, ...] = ("global",)
    window: int | None = None          # sliding-window width ("local")
    attn_softcap: float | None = None  # gemma2 attention logit softcap
    final_softcap: float | None = None  # gemma2 final logit softcap
    qk_norm: bool = False
    causal: bool = True                   # False => encoder-only (hubert)
    has_embedding: bool = True            # False => frame-embedding input
    post_norm: bool = False               # gemma2-style post-layer norms
    tie_embeddings: bool = True
    act: str = "silu"                     # "silu" (SwiGLU) | "gelu" (GeGLU)
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    capacity_factor: float = 2.0
    # Recurrent (rglru / xlstm)
    d_rnn: int = 0
    conv_width: int = 4
    rnn_heads: int = 0                    # xLSTM heads
    # Runtime knobs (overridden by shapes / perf iterations)
    dtype: str = "bfloat16"
    cache_dtype: str = ""        # "" = dtype; "float8_e4m3fn" halves KV
    # JAX package names; the port reads "xla" as "torch", "pallas" as "cuda"
    attn_impl: str = "xla"                # "xla" | "pallas" | "interpret"
    rnn_impl: str = "xla"
    remat: bool = True
    scan_layers: bool = True
    block_q: int = 512
    block_k: int = 512

    # ------------------------------------------------------------------
    @property
    def n_cycles(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def tail_kinds(self) -> tuple[str, ...]:
        return self.pattern[: self.n_layers % len(self.pattern)]

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv * self.head_dim

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (all layers + embeddings)."""
        total = 0
        if self.has_embedding:
            total += self.vocab * self.d_model
            if not self.tie_embeddings:
                total += self.vocab * self.d_model
        else:
            total += self.d_model * self.d_model      # frontend adapter
            total += self.d_model * self.vocab        # classifier head
        total += self.d_model                          # final norm
        kinds = (list(self.pattern) * self.n_cycles) + list(self.tail_kinds)
        for kind in kinds:
            total += self._layer_params(kind)
        return total

    def _layer_params(self, kind: str) -> int:
        d = self.d_model
        n = 0
        if kind in ("global", "local", "moe"):
            n += d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
            n += 2 * d                                 # pre norms
            if self.post_norm:
                n += 2 * d
            if self.qk_norm:
                n += 2 * self.head_dim
            if kind == "moe":
                n += d * self.n_experts                # router
                n += self.n_experts * 3 * d * self.d_expert
            else:
                n += 3 * d * self.d_ff                 # SwiGLU/GeGLU
        elif kind == "rglru":
            dr = self.d_rnn or d
            n += 2 * d                                 # norms
            n += 2 * d * dr                            # rec + gate branch in
            n += self.conv_width * dr                  # temporal conv
            n += 3 * dr                                # Lambda, a-gate, i-gate
            n += 2 * dr * d                            # (a,i gates use W) out
            n += 3 * d * self.d_ff                     # GeGLU FFN
        elif kind == "mlstm":
            di = 2 * d                                 # up factor 2
            n += d + 2 * d * di                        # norm + two up projs
            n += self.conv_width * di
            n += 3 * di * di // max(self.rnn_heads, 1) * max(self.rnn_heads, 1)
            n += 3 * di                                # i, f, o gate projs
            n += di * d                                # down proj
        elif kind == "slstm":
            h = self.rnn_heads or 4
            dh = d // h
            n += d                                     # norm
            n += 4 * d * d                             # W gates
            n += 4 * h * dh * dh                       # block-diag R gates
            n += 4 * d                                 # biases
            n += 2 * d * math.ceil(4 * d / 3) // 1     # post-up FFN approx
        else:
            raise ValueError(kind)
        return int(n)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.param_count()
        total = self.param_count()
        kinds = (list(self.pattern) * self.n_cycles) + list(self.tail_kinds)
        n_moe = sum(1 for k in kinds if k == "moe")
        all_exp = n_moe * self.n_experts * 3 * self.d_model * self.d_expert
        act_exp = n_moe * self.top_k * 3 * self.d_model * self.d_expert
        return int(total - all_exp + act_exp)
