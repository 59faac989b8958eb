from .adamw import OptState, adamw_init, adamw_update, global_norm
from .schedules import constant_lr, cosine_lr, linear_warmup_cosine

__all__ = ["OptState", "adamw_init", "adamw_update", "global_norm",
           "cosine_lr", "constant_lr", "linear_warmup_cosine"]
