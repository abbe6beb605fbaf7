"""RAD-NeRF torso (port of ``geneface_tpu/models/radnerf/radnerf_torso.py``):
a 2-D deformation field rendered under the head.

The head pose (6-D, frequency degree 4), the screen coordinate (shrunk by
``torso_shrink``, frequency degree 10), a per-frame torso code and,
optionally, an encoding of the rendered head's colour and alpha feed a
deform MLP; its offset moves the coordinate into a tiled 2-D grid whose
feature, with the same inputs, feeds a canonical MLP → (alpha, RGB).

The torso grid's geometry follows the head's levels: ``grid_num_levels`` ×
``grid_level_dim`` of the config, hashmap cap ``16 − round(log2(C/2))``,
finest resolution 2048, tiled, linear, in the head's ``grid_backend`` (with
the fused layout's default grouping: its ``ungroup_coarse`` is not the
head's; it takes the head's ``grid_compute_dtype`` but not its
``grid_bwd_dtype``, as in the JAX package). The torso MLPs compute in float32 even when the head's
compute in bf16, as the JAX ``MLP``'s default dtype does.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from geneface_tpu_torch.models.radnerf.cond_encoder import MLP
from geneface_tpu_torch.models.radnerf.radnerf import RADNeRF
from geneface_tpu_torch.ops import (
    freq_encode,
    freq_encode_output_dim,
    make_fused_grid_meta,
    make_grid_meta,
)
from geneface_tpu_torch.ops.encoders import make_block_grid_meta

__all__ = ["RADNeRFTorso", "sample_torso_occupancy"]

#: frequency degrees of the pose and of the screen coordinate
POSE_DEGREE = 4
COORD_DEGREE = 10


class RADNeRFTorso(RADNeRF):
    """:class:`RADNeRF` plus the torso field; the extra keyword arguments
    are the config keys of the same names."""

    def __init__(
        self,
        torso_shrink: float = 0.8,
        torso_individual_embedding_dim: int = 8,
        torso_head_aware: bool = False,
        **head_kwargs,
    ):
        super().__init__(**head_kwargs)
        self.torso_shrink = float(torso_shrink)
        self.torso_head_aware = bool(torso_head_aware)
        C = head_kwargs.get("grid_level_dim", 4)
        torso_meta = make_grid_meta(
            input_dim=2,
            num_levels=head_kwargs.get("grid_num_levels", 8),
            level_dim=C,
            base_resolution=16,
            log2_hashmap_size=16 - int(round(math.log2(C / 2))),
            desired_resolution=2048,
            gridtype="tiled",
        )
        self.torso_grid_meta = torso_meta
        self.torso_block_meta = make_block_grid_meta(torso_meta)
        # the torso grid reads the screen coordinates of the batch's pixels,
        # which fall evenly over its tables
        self.torso_fused_meta = make_fused_grid_meta(
            torso_meta, row_lanes=head_kwargs.get("fused_row_lanes", 256), spread=True,
            compute=self.grid_compute_dtype,
        )
        self.torso_embeddings = self._grid_params(torso_meta, self.torso_fused_meta)
        if torso_individual_embedding_dim > 0:
            self.torso_individual_codes = nn.Parameter(torch.zeros(
                head_kwargs.get("individual_embedding_num", 13000), torso_individual_embedding_dim
            ))
        else:
            self.torso_individual_codes = None
        h_dim = (
            freq_encode_output_dim(2, COORD_DEGREE) + freq_encode_output_dim(6, POSE_DEGREE)
            + max(torso_individual_embedding_dim, 0)
        )
        if self.torso_head_aware:
            self.head_aware_mlps = nn.ModuleList(
                [nn.Linear(4, 16), nn.Linear(16, 32), nn.Linear(32, 16)]
            )
            h_dim += 16
        self.torso_deform_net = MLP(h_dim, 2, 64, 3, torch.float32)
        self.torso_canonical_net = MLP(torso_meta.output_dim + h_dim, 4, 32, 3, torch.float32)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The head's seeded init (which also covers the torso MLPs and the
        head-aware layers: lecun-normal weights, zero biases), then the torso
        grid U(-1e-4, 1e-4) and the torso codes 0.1·N(0, 1)."""
        super().reset_parameters(generator)
        for table in self.grid_tensors(self.torso_embeddings):
            table.copy_((torch.rand(table.shape, generator=generator) * 2 - 1) * 1e-4)
        if self.torso_individual_codes is not None:
            codes = self.torso_individual_codes
            codes.copy_(torch.randn(codes.shape, generator=generator) * 0.1)

    def torso_grid_tables(self):
        """The torso grid's tables as the encoder reads them (see
        :meth:`grid_tables`)."""
        return self._grid_view(self.torso_embeddings, self.torso_fused_meta)

    def forward_torso(
        self,
        x: torch.Tensor,  # [N, 2] screen coords in [-1, 1]
        pose6: torch.Tensor,  # [1, 6] euler + translation head pose
        ind_code: torch.Tensor | None,  # [torso_ind_dim]
        head_image: torch.Tensor | None = None,  # [N, 3]
        head_weights_sum: torch.Tensor | None = None,  # [N, 1]
        tables=None,  # from torso_grid_tables(); built here if None
    ):
        """→ (alpha [N, 1], color [N, 3], deform Δxy [N, 2]), float32."""
        N = x.shape[0]
        x = x.float() * self.torso_shrink
        enc_pose = freq_encode(pose6.float(), POSE_DEGREE)
        parts = [freq_encode(x, COORD_DEGREE), enc_pose.expand(N, -1)]
        if ind_code is not None:
            parts.append(ind_code.float().reshape(1, -1).expand(N, -1))
        h = torch.cat(parts, dim=-1)
        if self.torso_head_aware:
            if head_image is None:
                head_image = x.new_zeros(N, 3)
                head_weights_sum = x.new_zeros(N, 1)
            ha = torch.cat([head_image.float(), head_weights_sum.float()], dim=-1)
            for i, layer in enumerate(self.head_aware_mlps):
                ha = layer(ha)
                if i < len(self.head_aware_mlps) - 1:
                    # flax's leaky_relu: slope 1 at 0, where the zero biases
                    # put every ray without a head
                    ha = torch.where(ha >= 0, ha, 0.02 * ha)
            h = torch.cat([h, ha], dim=-1)
        dx = self.torso_deform_net(h)
        x_def = (x + dx).clamp(-1.0, 1.0)
        tables = tables if tables is not None else self.torso_grid_tables()
        grid_feat = self._encode_grid(
            (x_def + 1.0) / 2.0, tables, self.torso_grid_meta, self.torso_block_meta,
            self.torso_fused_meta,
        )
        out = self.torso_canonical_net(torch.cat([grid_feat, h], dim=-1))
        return torch.sigmoid(out[..., :1]), torch.sigmoid(out[..., 1:]), dx


def sample_torso_occupancy(
    density_grid: torch.Tensor,  # [H*H], row = y, column = x
    coords: torch.Tensor,  # [N, 2] in [-1, 1], (x, y)
    grid_size: int,
) -> torch.Tensor:
    """Bilinear sample of the 2-D torso grid at screen coordinates
    (align-corners convention)."""
    H = grid_size
    g = density_grid.reshape(H, H)
    fx = (coords[:, 0] + 1.0) * 0.5 * (H - 1)
    fy = (coords[:, 1] + 1.0) * 0.5 * (H - 1)
    x0 = torch.floor(fx).to(torch.int64).clamp(0, H - 2)
    y0 = torch.floor(fy).to(torch.int64).clamp(0, H - 2)
    wx = fx - x0
    wy = fy - y0
    return (
        g[y0, x0] * (1 - wx) * (1 - wy)
        + g[y0, x0 + 1] * wx * (1 - wy)
        + g[y0 + 1, x0] * (1 - wx) * wy
        + g[y0 + 1, x0 + 1] * wx * wy
    )
