"""LR schedules: float32 tensor functions of an int step.

The counterpart of ``repro.optim.schedules``, with its cast points: the
step is an int32 tensor and every ratio is taken in float32.
"""
import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.int32)


def linear_warmup(step, *, peak, warmup):
    return peak * torch.clamp((_step(step) + 1) / max(warmup, 1), max=1.0)


def cosine_schedule(step, *, peak, warmup, total, floor=0.1):
    step = _step(step)
    warm = torch.clamp((step + 1) / max(warmup, 1), max=1.0)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
    return peak * warm * cos
