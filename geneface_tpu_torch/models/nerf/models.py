"""Vanilla NeRF models (port of ``geneface_tpu/models/nerf/models.py``):

- :class:`ADNeRF`: coarse and fine backbones on a DeepSpeech window
  ``[16, 29]`` through ``AudioNet`` and, with attention, ``AudioAttNet``
  over 8 frames;
- :class:`Lm3dNeRF`: the same on the normalized idexp lm3d (68×3), through
  an ``AudioNet`` window reducer (and ``AudioAttNet`` over ``smo_win_size``
  frames), or with ``use_window_cond: false`` a plain MLP (32, 32, 64,
  ``cond_dim``; leaky ReLU slope 0.02 between);
- :class:`ADNeRFTorso`: the torso field, conditioned on the window feature,
  the freq-encoded head pose (euler and translation, 6 bands) and with
  ``use_color`` the rendered head colour through a 16-32-16 encoder.

Positions are freq-encoded with 10 bands (63 columns) and view directions
with 4 (27). flax infers the input widths that torch needs: ``dim_in`` is
the condition's per-frame width (204 for lm3d, 29 for DeepSpeech, 44 for
esperanto). Module names follow the flax tree (``convert.nerf_flax_path``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from geneface_tpu_torch.models.nerf.backbone import NeRFBackbone
from geneface_tpu_torch.models.radnerf.cond_encoder import AudioAttNet, AudioNet
from geneface_tpu_torch.ops.encoders import freq_encode, freq_encode_output_dim

__all__ = ["ADNeRF", "Lm3dNeRF", "ADNeRFTorso", "POS_MULTIRES", "VIEW_MULTIRES"]

POS_MULTIRES = 10
VIEW_MULTIRES = 4


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.02)


class _CoarseFineNeRF(nn.Module):
    """Freq encoders and the coarse and fine backbones on ``cond_width``
    condition columns."""

    def __init__(self, cond_width: int, hidden_size: int):
        super().__init__()
        dim_pos = freq_encode_output_dim(3, POS_MULTIRES)
        dim_view = freq_encode_output_dim(3, VIEW_MULTIRES)
        self.model_coarse = NeRFBackbone(dim_pos + cond_width, dim_view, hid_dim=hidden_size)
        self.model_fine = NeRFBackbone(dim_pos + cond_width, dim_view, hid_dim=hidden_size)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init in the flax module's distributions: weights
        lecun-normal (std sqrt(1/fan_in)), biases 0."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * math.sqrt(1.0 / fan_in))
                if m.bias is not None:
                    m.bias.zero_()

    def forward(self, pos: torch.Tensor, cond_feat: torch.Tensor, view: torch.Tensor,
                run_model_fine: bool = True) -> torch.Tensor:
        """pos ``[N, S, 3]``, cond_feat ``[C]``/``[1, C]``/``[N, C]``, view
        ``[N, 3]`` → raw ``[N, S, 4]``."""
        with record_function("gf::freq_encode"):
            pos_embed = freq_encode(pos, POS_MULTIRES)
            view_embed = freq_encode(view, VIEW_MULTIRES)
        net = self.model_fine if run_model_fine else self.model_coarse
        return net(pos_embed, cond_feat, view_embed)


class ADNeRF(_CoarseFineNeRF):
    """DeepSpeech windows ``[B, 16, dim_in]``."""

    def __init__(self, dim_in: int = 29, cond_dim: int = 64, hidden_size: int = 256):
        super().__init__(cond_dim, hidden_size)
        self.aud_net = AudioNet(dim_in, dim_aud=cond_dim, win_size=16)
        self.audatt_net = AudioAttNet(in_out_dim=cond_dim, seq_len=8)

    def cal_cond_feat(self, cond: torch.Tensor, with_att: bool = False) -> torch.Tensor:
        """``[B, 16, dim_in]`` → ``[B, cond_dim]``, or with attention over
        the B = 8 frames ``[cond_dim]``."""
        feat = self.aud_net(cond)
        if with_att:
            feat = self.audatt_net(feat)
        return feat


class Lm3dNeRF(_CoarseFineNeRF):
    """Landmark condition: normalized idexp lm3d, 68·3 per frame."""

    def __init__(self, dim_in: int = 204, cond_dim: int = 64, hidden_size: int = 256,
                 use_window_cond: bool = True, cond_win_size: int = 1,
                 smo_win_size: int = 5, with_att: bool = True):
        super().__init__(cond_dim, hidden_size)
        self.use_window_cond = use_window_cond
        if use_window_cond:
            self.lm_encoder = AudioNet(dim_in, dim_aud=cond_dim, win_size=cond_win_size)
            if with_att:
                self.lmatt_encoder = AudioAttNet(in_out_dim=cond_dim, seq_len=smo_win_size)
        else:
            dims = (dim_in, 32, 32, 64, cond_dim)
            self.lm_encoder_mlp = nn.ModuleList(
                nn.Linear(dims[i], dims[i + 1]) for i in range(len(dims) - 1))

    def cal_cond_feat(self, cond: torch.Tensor, with_att: bool = False) -> torch.Tensor:
        """Window branch: ``[B, cond_win_size, dim_in]`` → ``[B, cond_dim]``,
        with attention over the B = ``smo_win_size`` frames ``[cond_dim]``;
        MLP branch: ``[..., dim_in]`` → ``[..., cond_dim]``."""
        if self.use_window_cond:
            feat = self.lm_encoder(cond)
            if with_att:
                feat = self.lmatt_encoder(feat)
            return feat
        feat = cond
        for i, layer in enumerate(self.lm_encoder_mlp):
            feat = layer(feat)
            if i < len(self.lm_encoder_mlp) - 1:
                feat = _lrelu(feat)
        return feat


class ADNeRFTorso(_CoarseFineNeRF):
    """Torso field on the window feature, the head pose and (``use_color``)
    the rendered head colour."""

    def __init__(self, dim_in: int = 29, cond_dim: int = 64, hidden_size: int = 256,
                 use_color: bool = False, pose_multires: int = 6, cond_win_size: int = 16,
                 smo_win_size: int = 8):
        pose_dim = freq_encode_output_dim(3, pose_multires)
        super().__init__(cond_dim + 2 * pose_dim + (16 if use_color else 0), hidden_size)
        self.use_color = use_color
        self.pose_multires = pose_multires
        self.aud_net = AudioNet(dim_in, dim_aud=cond_dim, win_size=cond_win_size)
        self.audatt_net = AudioAttNet(in_out_dim=cond_dim, seq_len=smo_win_size)
        if use_color:
            self.color_encoder = nn.ModuleList(
                [nn.Linear(3, 16), nn.Linear(16, 32), nn.Linear(32, 16)])

    def cal_cond_feat(self, cond: torch.Tensor, euler: torch.Tensor, trans: torch.Tensor,
                      color: torch.Tensor | None = None, with_att: bool = False) -> torch.Tensor:
        """cond ``[B, W, dim_in]``, euler and trans ``[3]``, color ``[N, 3]``
        (the rendered head pixels) → ``[1, F]`` or with colour ``[N, F]``."""
        feat = self.aud_net(cond)
        if with_att:
            feat = self.audatt_net(feat)
        if feat.dim() == 1:
            feat = feat[None]
        euler_emb = freq_encode(euler[None], self.pose_multires)
        trans_emb = freq_encode(trans[None], self.pose_multires)
        B = feat.shape[0]
        feat = torch.cat([feat, euler_emb.expand(B, euler_emb.shape[-1]),
                          trans_emb.expand(B, trans_emb.shape[-1])], dim=-1)
        if self.use_color:
            if color is None:
                raise ValueError("use_color=True requires head color input")
            cf = color
            for i, layer in enumerate(self.color_encoder):
                cf = layer(cf)
                if i < len(self.color_encoder) - 1:
                    cf = _lrelu(cf)
            feat = feat.reshape(1, -1).expand(cf.shape[0], feat.shape[-1])
            feat = torch.cat([feat, cf], dim=-1)
        return feat
