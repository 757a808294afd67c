"""Learning-rate schedules (pure functions of the step), the twin of
``repro.optim.schedules``: computed in f32 as the reference computes
them."""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def cosine_warmup(base_lr: float, warmup: int, total: int,
                  min_ratio: float = 0.1):
    """Linear warmup then cosine decay to min_ratio * base_lr.  The
    schedule takes a step (an int or a tensor) and returns a 0-d f32
    tensor on the step's device."""
    def schedule(step):
        step = torch.as_tensor(step).to(F32)
        warm = base_lr * torch.clamp_max(step / max(warmup, 1), 1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi
                                                                 * frac))
        return torch.where(step < warmup, warm, base_lr * cos)
    return schedule
