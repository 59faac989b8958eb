"""granite-moe-1b-a400m [moe] — 24L d1024 16H (GQA kv=8, head_dim 64),
MoE FFN: 32 experts top-8, d_expert 512, vocab 49155.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

Note vocab 49155 is not divisible by the 16-way model axis — the
sharding rules leave the embedding replicated (divisibility filter),
which is exactly the elastic-mesh behaviour DESIGN.md §5 describes.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv=8, head_dim=64,
    d_ff=0, vocab=49155,
    pattern=("moe",), n_experts=32, top_k=8, d_expert=512,
    capacity_factor=1.25, act="silu", tie_embeddings=True,
    rope_theta=10_000.0,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    vocab=509, n_experts=8, top_k=2, d_expert=32,   # odd vocab on purpose
    capacity_factor=8.0,   # no token drops at smoke scale
    dtype="float32", remat=False)
