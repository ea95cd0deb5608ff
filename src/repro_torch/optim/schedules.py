"""Learning-rate schedules, as ``repro/optim/schedules.py``: callables of
the optimizer's int32 step counter, each returning a float32 scalar
tensor on the counter's device, with the JAX package's float operations
in its order. The cosine is taken in float64 and rounded to float32:
PyTorch's float32 ``cos`` is a unit in the last place off the correctly
rounded value where XLA's is not (step 24 of 30). Nothing leaves the
device, so a schedule may run inside a captured CUDA graph."""

from __future__ import annotations

import math

import torch

__all__ = ["constant_schedule", "cosine_decay_schedule",
           "linear_warmup_cosine"]


def _cos(x: torch.Tensor) -> torch.Tensor:
    return torch.cos(x.double()).float()


def constant_schedule(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def cosine_decay_schedule(lr: float, decay_steps: int, alpha: float = 0.0):
    def fn(step):
        frac = torch.clamp(step.to(torch.float32) / decay_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + _cos(math.pi * frac))
        return lr * ((1 - alpha) * cos + alpha)
    return fn


def linear_warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    def fn(step):
        s = step.to(torch.float32)
        warm = lr * s / max(warmup_steps, 1)
        frac = torch.clamp(
            (s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0,
            1.0)
        cos = lr * (final_frac + (1 - final_frac) * 0.5
                    * (1.0 + _cos(math.pi * frac)))
        return torch.where(s < warmup_steps, warm, cos)
    return fn
