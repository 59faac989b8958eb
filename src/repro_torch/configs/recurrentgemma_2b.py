"""recurrentgemma-2b [hybrid] — 26L d2560 10H (MQA kv=1, head_dim 256)
ff7680 vocab 256000; Griffin pattern 2 RG-LRU : 1 local-attn(2048).
[arXiv:2402.19427; hf]

26 layers = 8 cycles of (rglru, rglru, local) + 2 tail rglru layers.
Bounded state (RG-LRU h + 2048-window KV) -> runs the long_500k shape.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv=1, head_dim=256,
    d_ff=7680, vocab=256000,
    pattern=("rglru", "rglru", "local"), window=2048, d_rnn=2560,
    act="gelu", tie_embeddings=True, rope_theta=10_000.0,
)

REDUCED = CONFIG.replace(
    n_layers=5, d_model=64, n_heads=4, n_kv=1, head_dim=16, d_ff=128,
    vocab=512, window=16, d_rnn=64, dtype="float32", remat=False)
