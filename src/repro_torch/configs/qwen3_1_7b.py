"""qwen3-1.7b [dense] — 28L d2048 16H (GQA kv=8, head_dim 128) ff6144
vocab 151936; qk-norm.  [hf:Qwen/Qwen3-8B family; hf]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv=8, head_dim=128,
    d_ff=6144, vocab=151936,
    pattern=("global",), qk_norm=True, act="silu",
    tie_embeddings=True, rope_theta=1_000_000.0,
)

REDUCED = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=128,
    vocab=512, dtype="float32", remat=False)
