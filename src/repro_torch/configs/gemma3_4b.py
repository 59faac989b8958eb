"""gemma3-4b [dense] — 34L d2560 8H (GQA kv=4, head_dim 256) ff10240
vocab 262144; 5:1 local(1024):global interleave, qk-norm, 128k context.
[hf:google/gemma-3 family; unverified]

34 layers = 5 full (5 local + 1 global) cycles + 4 tail local layers.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv=4, head_dim=256,
    d_ff=10240, vocab=262144,
    pattern=("local", "local", "local", "local", "local", "global"),
    window=1024, qk_norm=True, act="gelu", tie_embeddings=True,
    rope_theta=1_000_000.0,
)

REDUCED = CONFIG.replace(
    n_layers=8, d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=128,
    vocab=512, window=16, dtype="float32", remat=False)
