"""LR schedules (multiplier form: step -> factor in [0, 1]).  A step may be
a number or a tensor (the optimizer passes its int32 step on the device);
the factor is a float32 tensor on the step's device."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(warmup: int, total: int, min_frac: float = 0.1):
    def f(step):
        step = _f32(step)
        warm = step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)

    return f


def constant():
    return lambda step: torch.ones((), device=_f32(step).device)


def inverse_sqrt(warmup: int):
    def f(step):
        step = _f32(step)
        return torch.minimum(step / max(warmup, 1), torch.sqrt(warmup / torch.clamp(step, min=1)))

    return f
