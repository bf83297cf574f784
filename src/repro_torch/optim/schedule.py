"""Learning-rate schedules (warmup + cosine decay, constant, rsqrt).

The counterpart of ``repro/optim/schedule.py``: the same arithmetic in
fp32, on a 0-d tensor (on ``step``'s device when ``step`` is a tensor).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

__all__ = ["ScheduleConfig", "lr_at"]


@dataclass(frozen=True)
class ScheduleConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_ratio: float = 0.1
    kind: str = "cosine"  # | "constant" | "rsqrt"


def lr_at(step, cfg: ScheduleConfig) -> torch.Tensor:
    t = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * torch.clamp((t + 1) / max(cfg.warmup_steps, 1),
                                     max=1.0)
    if cfg.kind == "constant":
        return warm
    if cfg.kind == "rsqrt":
        post = cfg.peak_lr * torch.sqrt(
            cfg.warmup_steps / torch.clamp(t, min=cfg.warmup_steps))
        return torch.where(t < cfg.warmup_steps, warm, post)
    prog = torch.clamp(
        (t - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cos = cfg.min_ratio + (1 - cfg.min_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(t < cfg.warmup_steps, warm, cfg.peak_lr * cos)
