"""Vanilla NeRF backbone (port of ``geneface_tpu/models/nerf/backbone.py``):
an 8-layer density MLP on ``[positional encoding, condition]`` with the raw
input concatenated back after layer 4, sigma from the 256-wide state, and a
half-width colour branch on ``[state, view encoding]``.

The 13 biased linear layers sit in ``layers`` in the flax module's order
(``Dense_0`` … ``Dense_12``): density 0–7, sigma 8, colour 9–11, rgb 12.
Their products are float32 ``F.linear`` calls (TF32 stays off).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

__all__ = ["NeRFBackbone", "broadcast_cond"]


def broadcast_cond(cond: torch.Tensor, n: int, s: int) -> torch.Tensor:
    """A condition of ``[C]``, ``[1, C]`` or ``[N, C]`` → ``[N, S, C]``."""
    if cond.dim() == 1:
        return cond[None, None, :].expand(n, s, cond.shape[-1])
    return cond[:, None, :].expand(n, s, cond.shape[-1])


class NeRFBackbone(nn.Module):
    def __init__(self, dim_in: int, dim_view: int, hid_dim: int = 128,
                 num_density_linears: int = 8, num_color_linears: int = 3,
                 skip_layer_indices: Sequence[int] = (4,)):
        """``dim_in``: positional encoding plus condition columns;
        ``dim_view``: view encoding columns."""
        super().__init__()
        self.num_density_linears = num_density_linears
        self.skip_layer_indices = tuple(skip_layer_indices)
        dims = []
        d = dim_in
        for i in range(num_density_linears):
            dims.append((d, hid_dim))
            d = hid_dim + (dim_in if i in self.skip_layer_indices else 0)
        dims.append((d, 1))  # sigma
        d += dim_view
        for _ in range(num_color_linears):
            dims.append((d, hid_dim // 2))
            d = hid_dim // 2
        dims.append((d, 3))  # rgb
        self.layers = nn.ModuleList(nn.Linear(i, o) for i, o in dims)

    def forward(self, pos_embed: torch.Tensor, cond: torch.Tensor,
                view_embed: torch.Tensor) -> torch.Tensor:
        """pos_embed ``[N, S, P]``, cond ``[C]``/``[1, C]``/``[N, C]``,
        view_embed ``[N, V]`` → rgb and sigma logits ``[N, S, 4]``."""
        N, S, _ = pos_embed.shape
        with record_function("gf::backbone"):
            inp = torch.cat([pos_embed, broadcast_cond(cond, N, S)], dim=-1)
            h = inp
            nd = self.num_density_linears
            for i in range(nd):
                h = F.relu(self.layers[i](h))
                if i in self.skip_layer_indices:
                    h = torch.cat([inp, h], dim=-1)
            sigma = self.layers[nd](h)
            h = torch.cat([h, view_embed[:, None, :].expand(N, S, view_embed.shape[-1])], dim=-1)
            for lin in self.layers[nd + 1 : -1]:
                h = F.relu(lin(h))
            rgb = self.layers[-1](h)
            return torch.cat([rgb, sigma], dim=-1)
