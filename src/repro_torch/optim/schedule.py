"""Learning-rate schedules (pure functions of the step counter).

The port's copy of ``repro/optim/schedule.py``: float32 tensors of the step
counter with the reference's arithmetic, a Python scalar meeting a float32
tensor as the tensor's type, as in JAX.
"""

from __future__ import annotations

import math

import torch

__all__ = ["linear_warmup", "cosine_schedule"]


def linear_warmup(step, warmup_steps: int) -> torch.Tensor:
    s = torch.as_tensor(step, dtype=torch.float32)
    return torch.clamp((s + 1.0) / max(warmup_steps, 1), max=1.0)


def cosine_schedule(step, total_steps: int, warmup_steps: int = 0,
                    min_ratio: float = 0.1) -> torch.Tensor:
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = linear_warmup(step, warmup_steps)
    frac = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return warm * cos
