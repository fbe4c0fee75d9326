"""Learning-rate schedules as step -> scale functions (they multiply the
optimizer's peak lr), computed in f32 as the reference computes them."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(device="cpu", dtype=torch.float32)


def linear_warmup(step, warmup_steps: int) -> torch.Tensor:
    """min(1, (step + 1) / warmup_steps) as a 0-d f32 tensor."""
    return torch.clamp((_f32(step) + 1.0) / max(1, warmup_steps), max=1.0)


def cosine_schedule(step, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up, then a cosine decay to ``final_frac``."""
    s = _f32(step)
    warm = linear_warmup(step, warmup_steps)
    t = torch.clamp((s - warmup_steps) / max(1, total_steps - warmup_steps),
                    0.0, 1.0)
    cos = final_frac + (1.0 - final_frac) * 0.5 * (1.0 + torch.cos(math.pi * t))
    return warm * cos
