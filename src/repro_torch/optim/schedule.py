"""LR schedules: cosine and MiniCPM's WSD (warmup–stable–decay) (reference:
``repro/optim/schedule.py``).

``step`` is an int or an integer tensor (AdamW's ``state["step"]``); the
result is a float32 tensor on the step's device, computed in float32 as the
reference computes it.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(step, *, warmup: int, total: int, floor: float = 0.1):
    step = _f32(step)
    warm = step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)


def wsd_schedule(step, *, warmup: int, stable: int, decay: int,
                 floor: float = 0.01):
    """MiniCPM WSD: linear warmup, flat plateau, short exponential-ish decay."""
    step = _f32(step)
    warm = step / max(warmup, 1)
    in_decay = step - (warmup + stable)
    log_floor = torch.log(torch.tensor(floor, dtype=torch.float32,
                                       device=step.device))
    dec = torch.exp(log_floor * torch.clamp(in_decay / max(decay, 1), 0, 1))
    return torch.where(step < warmup, warm,
                       torch.where(in_decay < 0, torch.ones_like(dec), dec))
