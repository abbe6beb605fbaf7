"""Learning-rate schedules (port of ``geneface_tpu/training/schedules.py``).

Each schedule is a function of the optimizer's update count (a float32
tensor, counting from 0 as optax does) returning the float32 learning rate,
so the optimizer evaluates it on the device without a host sync.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

__all__ = [
    "none_schedule",
    "warmup_schedule",
    "rsqrt_schedule",
    "exponential_schedule",
    "cosine_schedule",
    "build_schedule",
]

Schedule = Callable[[torch.Tensor], torch.Tensor]

_MIN_LR = 1e-7


def none_schedule(lr: float) -> Schedule:
    return lambda step: torch.full_like(step, lr)


def warmup_schedule(lr: float, warmup_updates: int) -> Schedule:
    def fn(step):
        warm = torch.clamp(step / max(warmup_updates, 1), max=1.0)
        return torch.clamp(lr * warm, min=_MIN_LR)

    return fn


def rsqrt_schedule(lr: float, warmup_updates: int, hidden_size: int) -> Schedule:
    """``lr * warmup * rsqrt(step) * rsqrt(hidden)``."""

    def fn(step):
        warm = torch.clamp(step / max(warmup_updates, 1), max=1.0)
        rsqrt_decay = torch.clamp(step, min=warmup_updates) ** -0.5
        return torch.clamp(lr * warm * rsqrt_decay * hidden_size**-0.5, min=_MIN_LR)

    return fn


def exponential_schedule(lr: float, warmup_updates: int = 0,
                         decay_steps: int = 250_000) -> Schedule:
    """0.1× every ``decay_steps`` with an optional linear warm-up, floored at
    1e-7."""

    def fn(step):
        decayed = lr * torch.pow(torch.full_like(step, 0.1), step / decay_steps)
        if warmup_updates > 0:
            warm = torch.clamp(lr * torch.clamp(step / warmup_updates, max=1.0), min=_MIN_LR)
            return torch.where(step <= warmup_updates, warm, torch.clamp(decayed, min=_MIN_LR))
        return torch.clamp(decayed, min=_MIN_LR)

    return fn


def cosine_schedule(lr: float, warmup_updates: int, max_updates: int) -> Schedule:
    def fn(step):
        warm = torch.clamp(step / max(warmup_updates, 1), max=1.0)
        progress = torch.clamp(
            (step - warmup_updates) / max(max_updates - warmup_updates, 1), 0.0, 1.0
        )
        return torch.clamp(lr * warm * 0.5 * (1 + torch.cos(math.pi * progress)), min=_MIN_LR)

    return fn


def build_schedule(cfg) -> Schedule:
    """From the config keys ``scheduler`` / ``lr`` / ``warmup_updates``."""
    name = cfg.get("scheduler", "exponential")
    lr = cfg["lr"]
    warmup = cfg.get("warmup_updates", 0)
    if name in ("none", None):
        return none_schedule(lr)
    if name == "warmup":
        return warmup_schedule(lr, warmup)
    if name == "rsqrt":
        return rsqrt_schedule(lr, warmup, cfg.get("hidden_size", 256))
    if name == "exponential":
        return exponential_schedule(lr, warmup)
    if name == "cosine":
        return cosine_schedule(lr, warmup, cfg.get("max_updates", 250_000))
    raise ValueError(f"unknown scheduler {name!r}")
