"""Learning-rate schedules (pure functions of the step).

The port's counterpart of the JAX package's ``optim/schedule.py``: f32
arithmetic on a 0-d tensor, on the step's device, so the training step
never waits for the host.  (The reference's ``constant`` schedule has no
caller and is not ported.)
"""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warm-up from 0 over ``warmup_steps``, then cosine decay to
    ``min_ratio * peak_lr`` at ``total_steps``; 0-d f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    frac = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio)
                     * 0.5 * (1.0 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup_steps, warm, cos)
