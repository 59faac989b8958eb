"""Model zoo port: ``repro.models`` for the ported layer kinds.

``init_params`` / ``forward`` / ``train_loss`` / ``prefill`` /
``decode_step`` for every configuration whose layers are ``"global"``,
``"local"`` or ``"rglru"`` (see ``layers.py``).
"""
from .config import ArchConfig
from .model import (decode_step, forward, init_decode_cache, init_params,
                    param_count, prefill, train_loss)

__all__ = ["ArchConfig", "init_params", "forward", "train_loss",
           "param_count", "init_decode_cache", "prefill", "decode_step"]
