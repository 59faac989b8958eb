from .store import (latest_round, load_checkpoint, restore_or_init,
                    save_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_round",
           "restore_or_init"]
