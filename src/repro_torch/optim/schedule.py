"""Learning-rate schedules as ``step -> lr`` functions.

``step`` is an integer tensor (0-d, or any shape) and the value is a float32
tensor on its device, so a captured round evaluates its schedule on the card
from its round counter. The arithmetic is the reference's, in its order.
"""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "cosine_decay", "linear_warmup_cosine"]


def constant(lr: float):
    return lambda step: torch.full(step.shape, lr, dtype=torch.float32, device=step.device)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step: torch.Tensor) -> torch.Tensor:
        frac = torch.clamp(step.to(torch.float32) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return lr * (final_frac + (1.0 - final_frac) * cos)

    return f


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int, final_frac: float = 0.1):
    cos = cosine_decay(lr, max(total_steps - warmup, 1), final_frac)

    def f(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = lr * s / max(warmup, 1)
        return torch.where(step < warmup, warm, cos(step - warmup))

    return f
