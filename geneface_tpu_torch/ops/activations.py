"""Activations with custom gradients (port of ``geneface_tpu/ops/activations.py``)."""

from __future__ import annotations

import torch

__all__ = ["trunc_exp"]


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x32 = x.float()
        ctx.save_for_backward(x32)
        return torch.exp(x32)

    @staticmethod
    def backward(ctx, g):
        (x32,) = ctx.saved_tensors
        return g * torch.exp(x32.clamp(-15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """``exp`` in float32 whose gradient clamps the input to ±15."""
    return _TruncExp.apply(x)
