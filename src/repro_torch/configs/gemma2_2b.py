"""gemma2-2b [dense] — 26L d2304 8H (GQA kv=4, head_dim 256) ff9216
vocab 256000; 1:1 local(4096)/global alternation, attention-logit
softcap 50, final-logit softcap 30, post-layer norms.
[arXiv:2408.00118; hf]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv=4, head_dim=256,
    d_ff=9216, vocab=256000,
    pattern=("local", "global"), window=4096,
    attn_softcap=50.0, final_softcap=30.0,
    post_norm=True, act="gelu", tie_embeddings=True,
    rope_theta=10_000.0,
)

REDUCED = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=128,
    vocab=512, window=16, dtype="float32", remat=False)
