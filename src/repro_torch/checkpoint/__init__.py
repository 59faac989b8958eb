from .store import latest_round, load_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint", "latest_round"]
