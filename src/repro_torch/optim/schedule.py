"""LR schedules: the port of the JAX package's ``optim/schedule.py``."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total: int = 10_000, floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor * peak_lr`` at ``total``; computed in f32.  ``step`` is
    an int or a 0-d tensor (the optimizer's int32 counter, on its device:
    no host read); the result is a 0-d f32 tensor on that device.  At step
    0 with ``warmup >= 1`` it is 0."""
    if isinstance(step, torch.Tensor):
        step = step.float()
    else:
        step = torch.tensor(float(step), dtype=torch.float32)
    warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)
