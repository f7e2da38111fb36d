"""LR schedules (counterpart of ``repro.optim.schedule``): pure
functions of the step index, on Python numbers or tensors."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, warmup: int, total: int, min_ratio: float = 0.1):
    """Linear warm-up over ``warmup`` steps, then a cosine from 1 down to
    ``min_ratio`` at ``total``.  A tensor step is computed in f32, as the
    JAX version computes; a number in float64 and returned as a float."""
    if torch.is_tensor(step):
        s = step.float()
        warm = torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi
                                                                * prog))
        return warm * cos
    s = float(step)
    warm = min(s / max(warmup, 1), 1.0)
    prog = min(max((s - warmup) / max(total - warmup, 1), 0.0), 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * prog))
    return warm * cos
