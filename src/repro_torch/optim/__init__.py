from .optimizers import (Optimizer, adamw, adafactor, sgd_momentum,
                         clip_by_global_norm, cosine_schedule, get_optimizer)
from .tripre import tripre

__all__ = ["Optimizer", "adamw", "adafactor", "sgd_momentum", "tripre",
           "clip_by_global_norm", "cosine_schedule", "get_optimizer"]
