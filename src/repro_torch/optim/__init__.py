from .optimizers import (OptCfg, make_optimizer, Optimizer)
from .schedules import cosine_schedule, linear_warmup

__all__ = ["OptCfg", "make_optimizer", "Optimizer", "cosine_schedule",
           "linear_warmup"]
