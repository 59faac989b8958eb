"""deepseek-7b [dense] — 30L d4096 32H (MHA kv=32, head_dim 128)
ff11008 vocab 102400; llama-style architecture (SwiGLU, RoPE, RMSNorm).
[arXiv:2401.02954; hf]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv=32, head_dim=128,
    d_ff=11008, vocab=102400,
    pattern=("global",), act="silu", tie_embeddings=False,
    rope_theta=10_000.0,
)

REDUCED = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv=4, head_dim=16, d_ff=128,
    vocab=512, dtype="float32", remat=False)
