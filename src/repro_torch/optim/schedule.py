"""LR schedules (counterpart of ``repro/optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(
    step, peak_lr: float, warmup_steps: int, total_steps: int, min_ratio: float = 0.1
) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine down to ``min_ratio·peak_lr``
    at ``total_steps``: a 0-d f32 tensor on ``step``'s device (the CPU for a
    Python int), computed in f32 in the reference's order."""
    step = torch.as_tensor(step).to(torch.float32)

    def divisor(n: int) -> torch.Tensor:  # CUDA would multiply by 1/n for a Python n
        return torch.tensor(float(n), dtype=torch.float32, device=step.device)

    warm = peak_lr * step / divisor(max(warmup_steps, 1))
    prog = torch.clamp((step - warmup_steps) / divisor(max(total_steps - warmup_steps, 1)),
                       0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)
