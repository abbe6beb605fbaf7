"""Occupancy-grid dilation (port of ``dilate_grid3d``,
``geneface_tpu/ops/morton.py:68``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["dilate_grid3d"]


def dilate_grid3d(grid: torch.Tensor) -> torch.Tensor:
    """3×3×3 max-pool (stride 1, same padding, padded cells never win) over
    a ``[..., H, H, H]`` float grid — the occupancy dilation of the
    reference's ``morton3D_dilation``."""
    lead = grid.shape[:-3]
    x = grid.reshape((-1, 1) + tuple(grid.shape[-3:]))
    out = F.max_pool3d(x, kernel_size=3, stride=1, padding=1)
    return out.reshape(lead + tuple(grid.shape[-3:]))
