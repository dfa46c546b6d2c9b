"""LR schedules as pure functions of the step (port of
``repro.optim.schedules``): each returns a 0-d float32 tensor."""

from __future__ import annotations

import math

import torch


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    """Linear warm-up to ``base_lr`` over ``warmup_steps``, then a cosine
    decay to ``min_ratio * base_lr`` at ``total_steps``."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0, 1)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi
                                                                 * frac))
        return torch.where(step < warmup_steps, warm, base_lr * cos)

    return lr


def constant_lr(base_lr: float):
    return lambda step: torch.tensor(base_lr, dtype=torch.float32)
