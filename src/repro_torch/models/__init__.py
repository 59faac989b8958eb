"""Model zoo port: the dense decoder / encoder stack of ``repro.models``.

``init_params`` / ``forward`` / ``train_loss`` for every configuration
whose layers are all ``"global"`` (see ``layers.py``).
"""
from .config import ArchConfig
from .model import forward, init_params, param_count, train_loss

__all__ = ["ArchConfig", "init_params", "forward", "train_loss",
           "param_count"]
