"""olmoe-1b-7b [moe] — 16L d2048 16H (kv=16, head_dim 128), MoE FFN:
64 experts top-8, d_expert 1024, vocab 50304; qk-norm.
[arXiv:2409.02060; hf]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv=16, head_dim=128,
    d_ff=0, vocab=50304,
    pattern=("moe",), n_experts=64, top_k=8, d_expert=1024,
    capacity_factor=1.25, qk_norm=True, act="silu",
    tie_embeddings=False, rope_theta=10_000.0,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
    vocab=512, n_experts=8, top_k=2, d_expert=32,
    capacity_factor=8.0,   # no token drops at smoke scale
    dtype="float32", remat=False)
