"""Learning-rate schedules as step -> lr functions. ``step`` is an int or a
0-d integer tensor; the lr comes back as a 0-d fp32 tensor (on the step's
device), computed in fp32 as the reference computes it."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.int32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.0):
    def fn(step):
        frac = torch.clamp(_step(step).to(torch.float32) / decay_steps,
                           0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return lr * ((1 - alpha) * cos + alpha)

    return fn


def linear_warmup_cosine(lr: float, warmup_steps: int, decay_steps: int,
                         alpha: float = 0.0):
    cos = cosine_decay(lr, max(decay_steps - warmup_steps, 1), alpha)

    def fn(step):
        step = _step(step)
        s = step.to(torch.float32)
        warm = lr * s / max(warmup_steps, 1)
        return torch.where(step <= warmup_steps, warm,
                           cos(step - warmup_steps))

    return fn
