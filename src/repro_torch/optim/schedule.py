"""Learning-rate schedules (counterpart of ``repro/optim/schedule.py``):
functions of the step, a 0-d tensor, returning a 0-d f32 tensor on the
step's device."""
from __future__ import annotations

import math

import torch


def cosine_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup then cosine decay to final_frac·peak."""

    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)

    return lr


def constant(lr_value: float):
    return lambda step: torch.tensor(lr_value, dtype=torch.float32,
                                     device=torch.as_tensor(step).device)
