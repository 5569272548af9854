"""Learning-rate schedules as step → lr callables for ``AdamW.lr``: the
reference's f32 arithmetic on a step tensor."""

from __future__ import annotations

import math

import torch


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _progress(s: torch.Tensor, warmup: int, total: int) -> torch.Tensor:
    return torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.0):
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = _f32(peak, s) * s / max(warmup, 1)
        prog = _progress(s, warmup, total)
        cos = floor + (peak - floor) * 0.5 * (
            1 + torch.cos(_f32(math.pi, s) * prog))
        return torch.where(s < warmup, warm, cos)
    return lr


def warmup_linear(peak: float, warmup: int, total: int, floor: float = 0.0):
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = _f32(peak, s) * s / max(warmup, 1)
        prog = _progress(s, warmup, total)
        lin = peak + (floor - peak) * prog
        return torch.where(s < warmup, warm, lin)
    return lr
