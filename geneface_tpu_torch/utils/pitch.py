"""Pitch quantization (port of ``geneface_tpu/utils/pitch.py``)."""

from __future__ import annotations

import math

import torch

__all__ = ["f0_to_coarse", "coarse_to_f0", "F0_BIN"]

F0_BIN = 256
F0_MAX = 1100.0
F0_MIN = 50.0
_MEL_MIN = 1127 * math.log(1 + F0_MIN / 700)
_MEL_MAX = 1127 * math.log(1 + F0_MAX / 700)


def f0_to_coarse(f0) -> torch.Tensor:
    """Hz → coarse bin index in [1, 255] (int64); unvoiced (f0 <= 0) → 1.
    Rounds as ``floor(mel + 0.5)``."""
    f0 = torch.as_tensor(f0, dtype=torch.float32)
    mel = 1127 * torch.log(1 + f0.clamp(min=0.0) / 700)
    mel = torch.where(mel > 0, (mel - _MEL_MIN) * (F0_BIN - 2) / (_MEL_MAX - _MEL_MIN) + 1, mel)
    mel = mel.clamp(1.0, F0_BIN - 1)
    return torch.floor(mel + 0.5).long()


def coarse_to_f0(coarse) -> torch.Tensor:
    """Coarse bin → Hz (bin 1 → 0, unvoiced)."""
    coarse = torch.as_tensor(coarse)
    mel = (coarse - 1) * (_MEL_MAX - _MEL_MIN) / (F0_BIN - 2) + _MEL_MIN
    f0 = (torch.exp(mel / 1127) - 1) * 700
    return torch.where(coarse == 1, torch.zeros_like(f0), f0)
