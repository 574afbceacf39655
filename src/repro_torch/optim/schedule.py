"""LR schedules (pure functions of the step)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to `peak` over `warmup` steps, then a cosine decay to
    `floor`·peak at `total`; an f32 tensor on the step's device (the CPU
    for a Python number)."""
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = peak * s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup, warm, cos)
