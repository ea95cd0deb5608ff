"""Functional optimizers over dicts of tensors, and learning-rate
schedules, as ``repro/optim``."""

from repro_torch.optim.adamw import (Optimizer, adam, adamw,
                                     clip_by_global_norm, sgd)
from repro_torch.optim.schedules import (constant_schedule,
                                         cosine_decay_schedule,
                                         linear_warmup_cosine)

__all__ = ["Optimizer", "adam", "adamw", "sgd", "clip_by_global_norm",
           "constant_schedule", "cosine_decay_schedule",
           "linear_warmup_cosine"]
