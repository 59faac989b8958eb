"""hubert-xlarge [audio] — 48L encoder-only d1280 16H (kv=16,
head_dim 80) ff5120, 504 masked-prediction classes.
[arXiv:2106.07447; unverified]

The conv waveform frontend is a STUB per the assignment:
``input_specs()`` provides precomputed frame embeddings (B, T, d_model);
the model applies a learned linear adapter + bidirectional encoder +
classification head.  No decode shapes (encoder-only).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv=16, head_dim=80,
    d_ff=5120, vocab=504,
    pattern=("global",), causal=False, has_embedding=False,
    act="gelu", tie_embeddings=False,
)

REDUCED = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv=4, head_dim=16, d_ff=128,
    vocab=32, dtype="float32", remat=False)
