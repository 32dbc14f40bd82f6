"""Learning-rate schedules (pure functions of the int32 step tensor; the
result is an f32 tensor on the step's device, so no host sync)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32) + 1.0   # lr(0) > 0
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule


def constant(lr: float):
    def schedule(step):
        return torch.full((), lr, dtype=torch.float32,
                          device=torch.as_tensor(step).device)
    return schedule
