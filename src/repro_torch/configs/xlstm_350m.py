"""xlstm-350m [ssm] — 24 blocks d1024, mLSTM:sLSTM 7:1 interleave,
4 heads, no external FFN (d_ff=0; blocks carry internal up/down
projections), vocab 50304.  [arXiv:2405.04517; unverified]

24 layers = 3 cycles of (7 mLSTM + 1 sLSTM).  Pure recurrent state ->
runs the long_500k shape.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv=4, head_dim=256,
    d_ff=0, vocab=50304,
    pattern=("mlstm",) * 7 + ("slstm",), rnn_heads=4,
    act="gelu", tie_embeddings=True,
)

REDUCED = CONFIG.replace(
    n_layers=8, d_model=64, n_heads=4, n_kv=4, head_dim=16,
    vocab=512, rnn_heads=4, dtype="float32", remat=False)
