"""Person-specific post-net, inference side (port of
``geneface_tpu/models/postnet/models.py``): ``CNNPostNet`` and
``PitchContourCNNPostNet``, 1-D conv stacks that predict a landmark delta,
``refined = x + Δ``, with the all-zero (padding) frames masked out; and
``MLPDiscriminator``, the frame-wise real/fake head of the adversarial
training.

Layout: channel-last ``[B, T, C]`` at the boundary, as the JAX modules;
channel-first inside. ``norm`` ``"ln"`` is flax's ``LayerNorm()``
(epsilon 1e-6), ``"bn"`` BatchNorm on running statistics (epsilon 1e-5).
Submodules carry the flax names (``_RefinerCore_0._ConvBlock_<i>.Conv_0``,
the discriminator's ``Dense_0..4``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from geneface_tpu_torch.models.layers import PadConv1d, channel_norm

__all__ = ["CNNPostNet", "PitchContourCNNPostNet", "MLPDiscriminator"]


class _ConvBlock(nn.Module):
    """conv 3 (padding 1) → norm → (+ input) → leaky ReLU 0.2."""

    def __init__(self, cin: int, cout: int, residual: bool = False, norm: str = "ln"):
        super().__init__()
        self.residual = residual
        self.Conv_0 = PadConv1d(cin, cout, 3, pad=(1, 1))
        self.norm_name = "BatchNorm_0" if norm == "bn" else "LayerNorm_0"
        self.add_module(self.norm_name, channel_norm(norm, cout))

    def forward(self, x):
        out = getattr(self, self.norm_name)(self.Conv_0(x))
        if self.residual:
            out = out + x
        return F.leaky_relu(out, 0.2)


class _RefinerCore(nn.Module):
    PLAN = ((128, False), (128, True), (128, True), (256, False), (256, True), (256, True),
            (128, False))

    def __init__(self, in_dim: int, in_out_dim: int, norm: str = "ln"):
        super().__init__()
        cin = in_dim
        for i, (cout, res) in enumerate(self.PLAN):
            self.add_module(f"_ConvBlock_{i}", _ConvBlock(cin, cout, res, norm))
            cin = cout
        self.Conv_0 = PadConv1d(cin, in_out_dim, 1)

    def forward(self, inp, x, mask):
        """inp [B, C_in, T], x [B, C, T], mask [B, 1, T] → x + Δ."""
        h = inp
        for i in range(len(self.PLAN)):
            h = getattr(self, f"_ConvBlock_{i}")(h)
            if i in (2, 5):
                h = h * mask
        return x + self.Conv_0(h) * mask


def _frame_mask(x):
    """``[B, T, C]`` → ``[B, 1, T]``: 1 where a frame has a non-zero entry."""
    return (x.abs().sum(-1) != 0).to(x.dtype)[:, None]


class CNNPostNet(nn.Module):
    def __init__(self, in_out_dim: int = 64, norm: str = "ln"):
        super().__init__()
        self._RefinerCore_0 = _RefinerCore(in_out_dim, in_out_dim, norm)

    def forward(self, x):
        """x [B, T, C] → refined [B, T, C]."""
        xc = x.transpose(1, 2)
        return self._RefinerCore_0(xc, xc, _frame_mask(x)).transpose(1, 2)


class PitchContourCNNPostNet(nn.Module):
    def __init__(self, in_out_dim: int = 64, pitch_dim: int = 32, norm: str = "ln"):
        super().__init__()
        self._RefinerCore_0 = _RefinerCore(in_out_dim + pitch_dim, in_out_dim, norm)

    def forward(self, x, pitch):
        """x [B, T, C], pitch [B, T, pitch_dim] → refined [B, T, C]."""
        xc = x.transpose(1, 2)
        inp = torch.cat([x, pitch], dim=-1).transpose(1, 2)
        return self._RefinerCore_0(inp, xc, _frame_mask(x)).transpose(1, 2)


class MLPDiscriminator(nn.Module):
    """Four leaky-ReLU (0.2) dense layers (128, 256, 256, 128) and a
    bias-free head, frame by frame. The JAX module's dropout (0.25) runs
    only when it is called with ``deterministic=False``, which its task
    never does, so it is left out."""

    WIDTHS = (128, 256, 256, 128)

    def __init__(self, in_dim: int = 64):
        super().__init__()
        cin = in_dim
        for i, w in enumerate(self.WIDTHS):
            self.add_module(f"Dense_{i}", nn.Linear(cin, w))
            cin = w
        self.add_module(f"Dense_{len(self.WIDTHS)}", nn.Linear(cin, 1, bias=False))

    def forward(self, x):
        """x [B, T, C] → (validity [B, T, 1], frame mask [B, T], True where
        a frame has a non-zero entry)."""
        mask = x.abs().sum(-1) != 0
        h = x
        for i in range(len(self.WIDTHS)):
            h = F.leaky_relu(getattr(self, f"Dense_{i}")(h), 0.2)
        return getattr(self, f"Dense_{len(self.WIDTHS)}")(h), mask
