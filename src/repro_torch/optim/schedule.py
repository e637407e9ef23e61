"""Learning-rate schedules (the port of `repro.optim.schedule`).

`step` is an int tensor (the train state's step counter, on its device);
the result is an f32 tensor of the same device, computed as the reference
computes it: the step divided in f32, the cosine in f32.
"""
from __future__ import annotations

import math

import torch


def cosine_schedule(step: torch.Tensor, total_steps: int,
                    final_frac: float = 0.1) -> torch.Tensor:
    frac = torch.clamp(step.float() / max(total_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return final_frac + (1.0 - final_frac) * cos


def linear_warmup_cosine(step: torch.Tensor, warmup_steps: int,
                         total_steps: int,
                         final_frac: float = 0.1) -> torch.Tensor:
    warm = torch.clamp(step.float() / max(warmup_steps, 1), 0.0, 1.0)
    return warm * cosine_schedule(
        torch.clamp(step - warmup_steps, min=0),
        max(total_steps - warmup_steps, 1), final_frac)
