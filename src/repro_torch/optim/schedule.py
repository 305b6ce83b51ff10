"""LR schedules, the JAX package's ``optim/schedule.py``: fp32 tensors
of the step."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    def fn(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1),
            0.0, 1.0,
        )
        cos = floor + (peak_lr - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, cos)

    return fn
