"""Learning-rate schedules (pure functions of the step), after
``repro/optim/schedule.py``: float32 arithmetic on a step tensor, on the
step's device, so a train step reads its lr without a host sync."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, base_lr: float, total_steps: int,
                    min_ratio: float = 0.1):
    t = torch.clamp(step.float() / max(total_steps, 1), 0.0, 1.0)
    return base_lr * (min_ratio + (1 - min_ratio) * 0.5
                      * (1 + torch.cos(math.pi * t)))


def linear_warmup_cosine(step, base_lr: float, warmup_steps: int,
                         total_steps: int, min_ratio: float = 0.1):
    s = step.float()
    warm = base_lr * s / max(warmup_steps, 1)
    cos = cosine_schedule(step - warmup_steps, base_lr,
                          max(total_steps - warmup_steps, 1), min_ratio)
    return torch.where(s < warmup_steps, warm, cos)
