"""LR schedules: pure functions of the step (an int tensor), in f32."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, total_steps: int, min_ratio: float = 0.1):
    t = torch.clamp(step.float() / max(1, total_steps), 0.0, 1.0)
    return min_ratio + (1.0 - min_ratio) * 0.5 * (1.0 + torch.cos(math.pi * t))


def linear_warmup_cosine(step, warmup: int, total_steps: int,
                         min_ratio: float = 0.1):
    s = step.float()
    w = torch.clamp(s / max(1, warmup), 0.0, 1.0)
    return w * cosine_schedule(torch.clamp(s - warmup, min=0.0),
                               max(1, total_steps - warmup), min_ratio)
