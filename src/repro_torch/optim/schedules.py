"""Learning-rate schedules (port of ``repro/optim/schedules.py``).

``step_decay`` is the paper's schedule (x0.1 at fixed epochs); ``cosine``
with warmup is the LM default.  Each returns the rate as a Python float
holding the fp32 value the reference's traced arithmetic gives.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def constant(lr: float):
    rate = float(torch.tensor(lr, dtype=F32))
    return lambda step: rate


def step_decay(lr: float, boundaries, factor: float = 0.1):
    bounds = tuple(boundaries)

    def f(step):
        k = float(sum(1 for b in bounds if step >= b))
        return float(torch.tensor(lr, dtype=F32)
                     * torch.tensor(factor, dtype=F32) ** k)
    return f


def cosine(lr: float, total_steps: int, warmup: int = 0,
           final_lr: float = 0.0):
    def f(step):
        s = torch.tensor(float(step), dtype=F32)
        warm = lr * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total_steps - warmup, 1), 0, 1)
        cos = final_lr + 0.5 * (lr - final_lr) * (1 + torch.cos(math.pi * t))
        return float(torch.where(s < warmup, warm, cos))
    return f
