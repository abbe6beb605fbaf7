"""Landmark/HuBERT SyncNet (port of ``geneface_tpu/models/syncnet/models.py``):
a HuBERT tower over 10-frame audio clips and a mouth-landmark tower over
5-frame clips, each reduced to one L2-normalized 512-D embedding; the sync
loss is BCE on their cosine.

Layout: channel-last clips ``[K, T, C]`` at the boundary, channel-first
inside. ``norm`` ``"ln"`` is flax's ``LayerNorm()`` (epsilon 1e-6), ``"bn"``
BatchNorm on frozen running statistics (epsilon 1e-5, the imported GeneFace
checkpoints). The blocks carry the flax names: the audio tower is traced
first, so ``ConvBlock_0..12`` are the audio tower and ``ConvBlock_13..25``
the mouth tower, each with ``Conv_0`` and ``LayerNorm_0`` / ``BatchNorm_0``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from geneface_tpu_torch.models.layers import PadConv1d, channel_norm

__all__ = ["LandmarkHubertSyncNet", "sync_loss", "AUDIO_PLAN", "MOUTH_PLAN"]

#: (cout, kernel, stride, padding, residual) of each block; the
#: ``(512, 3, 1, 0)`` block takes both towers to one frame
AUDIO_PLAN = (
    (128, 3, 1, 1, False),
    (128, 3, 1, 1, False), (128, 3, 1, 1, True), (128, 3, 1, 1, True),
    (256, 3, 2, 1, False), (256, 3, 1, 1, True), (256, 3, 1, 1, True),
    (512, 3, 2, 1, False), (512, 3, 1, 1, True), (512, 3, 1, 1, True),
    (512, 3, 1, 1, False), (512, 3, 1, 0, False), (512, 1, 1, 0, False),
)
MOUTH_PLAN = (
    (96, 3, 1, 1, False),
    (128, 3, 1, 1, False), (128, 3, 1, 1, True), (128, 3, 1, 1, True),
    (256, 3, 2, 1, False), (256, 3, 1, 1, True), (256, 3, 1, 1, True),
    (512, 3, 1, 1, False), (512, 3, 1, 1, True), (512, 3, 1, 1, True),
    (512, 3, 1, 1, False), (512, 3, 1, 0, False), (512, 1, 1, 0, False),
)


class ConvBlock(nn.Module):
    """conv → norm → (+ input) → ReLU on ``[B, C, T]``."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, residual: bool = False, norm: str = "ln"):
        super().__init__()
        self.residual = residual
        self.Conv_0 = PadConv1d(cin, cout, kernel, stride=stride, pad=(padding, padding))
        self.norm_name = "BatchNorm_0" if norm == "bn" else "LayerNorm_0"
        self.add_module(self.norm_name, channel_norm(norm, cout))

    def forward(self, x):
        out = getattr(self, self.norm_name)(self.Conv_0(x))
        if self.residual:
            out = out + x
        return F.relu(out)


class LandmarkHubertSyncNet(nn.Module):
    def __init__(self, lm_dim: int = 60, norm: str = "ln"):
        super().__init__()
        self.n_audio = len(AUDIO_PLAN)
        blocks = [(1024, AUDIO_PLAN), (lm_dim, MOUTH_PLAN)]
        i = 0
        for cin, plan in blocks:
            for cout, k, s, p, res in plan:
                self.add_module(f"ConvBlock_{i}", ConvBlock(cin, cout, k, s, p, res, norm))
                cin = cout
                i += 1

    def _tower(self, x, first: int, n: int):
        x = x.transpose(1, 2)
        for i in range(first, first + n):
            x = getattr(self, f"ConvBlock_{i}")(x)
        return x.reshape(x.shape[0], -1)

    def forward(self, hubert, mouth_lm):
        """hubert ``[K, 10, 1024]``, mouth_lm ``[K, 5, lm_dim]`` →
        (audio_emb ``[K, 512]``, mouth_emb ``[K, 512]``), L2-normalized."""
        a = self._tower(hubert, 0, self.n_audio)
        m = self._tower(mouth_lm, self.n_audio, len(MOUTH_PLAN))
        a = a / torch.clamp(torch.linalg.norm(a, dim=-1, keepdim=True), min=1e-8)
        m = m / torch.clamp(torch.linalg.norm(m, dim=-1, keepdim=True), min=1e-8)
        return a, m


def sync_loss(audio_emb, mouth_emb, label):
    """BCE on the cosine, clipped to ``[1e-7, 1 - 1e-7]``; ``label`` ∈ {0, 1}
    ``[K]`` → (mean loss, cosine ``[K]``)."""
    d = torch.clamp((audio_emb * mouth_emb).sum(-1), 1e-7, 1 - 1e-7)
    label = torch.as_tensor(label, dtype=torch.float32, device=d.device)
    loss = -(label * torch.log(d) + (1 - label) * torch.log(1 - d))
    return loss.mean(), d
