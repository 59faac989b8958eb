"""chameleon-34b [vlm] — 48L d8192 64H (GQA kv=8, head_dim 128)
ff22016 vocab 65536; early-fusion decoder, VQ image tokens share the
text vocabulary; qk-norm.  [arXiv:2405.09818; unverified]

The VQ image tokenizer frontend is a STUB per the assignment: image
patches arrive as token ids in the shared 65536 vocab, so
``input_specs()`` is the ordinary (B, T) token layout.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv=8, head_dim=128,
    d_ff=22016, vocab=65536,
    pattern=("global",), qk_norm=True, act="silu",
    tie_embeddings=False, rope_theta=10_000.0,
)

REDUCED = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=128,
    vocab=512, dtype="float32", remat=False)
