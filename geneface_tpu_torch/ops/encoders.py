"""Frequency and SH encodings and multi-resolution grid metadata (port of
the parts of ``geneface_tpu/ops/encoders.py`` that the fused grid backend
and the torso use)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "freq_encode",
    "freq_encode_output_dim",
    "sh_encode",
    "GridMeta",
    "make_grid_meta",
    "HASH_PRIMES",
]

#: prime-xor hash constants of the reference grid encoder
HASH_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)


def freq_encode(x: torch.Tensor, degree: int) -> torch.Tensor:
    """NeRF positional encoding ``[x, sin(2^0 x), cos(2^0 x), sin(2^1 x),
    ...]``: the ``D`` input columns, then per frequency a ``sin`` block and
    a ``cos`` block of ``D`` columns each."""
    cols = [x]
    for f in range(degree):
        scaled = x * (2.0**f)
        cols.append(torch.sin(scaled))
        cols.append(torch.cos(scaled))
    return torch.cat(cols, dim=-1)


def freq_encode_output_dim(input_dim: int, degree: int) -> int:
    return input_dim * (1 + 2 * degree)


def sh_encode(d: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Real spherical harmonics of ``degree`` ∈ [1, 4] on unit directions
    ``d [..., 3]`` (instant-ngp sign convention) → ``[..., degree²]``.
    The model uses degree 4; higher degrees are not ported."""
    if not 1 <= degree <= 4:
        raise ValueError(f"sh degree must be in [1, 4], got {degree}")
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 2:
        out += [
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
        ]
    if degree >= 3:
        out += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * z2 - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * x2 - 0.54627421529603959 * y2,
        ]
    if degree >= 4:
        out += [
            0.59004358992664352 * y * (-3.0 * x2 + y2),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * z2),
            0.3731763325901154 * z * (5.0 * z2 - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * z2),
            1.4453057213202769 * z * (x2 - y2),
            0.59004358992664352 * x * (-x2 + 3.0 * y2),
        ]
    return torch.stack(out, dim=-1)


class GridMeta(NamedTuple):
    """Static metadata for a multi-resolution grid encoder."""

    input_dim: int
    num_levels: int
    level_dim: int
    base_resolution: int
    per_level_scale: float
    offsets: tuple  # [L+1] starts of each level in the canonical table
    gridtype: str  # "hash" | "tiled"
    align_corners: bool
    interpolation: str  # "linear" | "smoothstep"

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim


def make_grid_meta(
    input_dim: int = 3,
    num_levels: int = 16,
    level_dim: int = 2,
    base_resolution: int = 16,
    log2_hashmap_size: int = 19,
    desired_resolution: int | None = None,
    per_level_scale: float = 2.0,
    gridtype: str = "hash",
    align_corners: bool = False,
    interpolation: str = "linear",
) -> GridMeta:
    """Level layout of the reference encoder: per-level entry count is
    ``min(2^log2_hashmap_size, side^D)`` rounded up to a multiple of 8."""
    if desired_resolution is not None:
        per_level_scale = float(
            np.exp2(np.log2(desired_resolution / base_resolution) / max(num_levels - 1, 1))
        )
    max_params = 2**log2_hashmap_size
    offsets = [0]
    for lvl in range(num_levels):
        res = int(np.ceil(base_resolution * per_level_scale**lvl))
        side = res if align_corners else res + 1
        n = min(max_params, side**input_dim)
        n = int(np.ceil(n / 8) * 8)
        offsets.append(offsets[-1] + n)
    return GridMeta(
        input_dim=input_dim,
        num_levels=num_levels,
        level_dim=level_dim,
        base_resolution=base_resolution,
        per_level_scale=per_level_scale,
        offsets=tuple(offsets),
        gridtype=gridtype,
        align_corners=align_corners,
        interpolation=interpolation,
    )
