"""LR schedules: linear warmup + cosine decay (the standard LM recipe); the
port of ``repro.optim.schedule``, in f32 as JAX computes them."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr, warmup_steps, total_steps,
                  final_frac=0.1):
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                    0.0, 1.0)
    cos = final_frac * peak_lr + (1 - final_frac) * peak_lr * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, *, peak_lr, **_):
    return torch.tensor(peak_lr, dtype=torch.float32)
