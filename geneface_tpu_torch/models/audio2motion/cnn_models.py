"""1-D convolutional sequence generators (port of
``geneface_tpu/models/audio2motion/cnn_models.py``): ``ResidualBlock``,
``ConvBlocks``, the three backbones (``ResBlocksBackbone``,
``ResNetBackbone``, ``UNetBackbone``) and ``SeqLevelConvolutionalModel``.

Layout: the model takes the JAX batch (channel-last ``audio [B, T, 29]``,
``energy [B, T, 1]`` or ``mel [B, T, 80]``, ``style [B, 135]``,
``x_mask [B, T]``) and returns channel-last ``[B, T/2, out_dim]`` and its
mask; inside everything is channel-first ``[B, C, T]``. Submodules carry
the flax names. flax's conventions where they differ from torch's: GELU is
the tanh approximation, LayerNorm's epsilon is 1e-6, PReLU's slope is one
scalar starting at 0.01, and the time resampling is
``jax.image.resize(method="linear")``, which filters when it shrinks
(:func:`resample_time`). Dropout follows the module's ``training`` flag.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from geneface_tpu_torch.models.layers import FLAX_LN_EPS, ChannelLayerNorm, PadConv1d, same_padding

__all__ = [
    "resample_time",
    "ResidualBlock",
    "ConvBlocks",
    "ResBlocksBackbone",
    "ResNetBackbone",
    "UNetBackbone",
    "SeqLevelConvolutionalModel",
]


@functools.lru_cache(maxsize=64)
def _resample_matrix(n_in: int, n_out: int) -> np.ndarray:
    """``[n_in, n_out]`` float32 weights of ``jax.image.resize``'s linear
    method along one axis: a triangle filter at the output's sample points,
    widened by ``n_in/n_out`` when it shrinks (its antialiasing), each
    column renormalized to sum 1, zero where the sample point lies outside
    the input; computed in float32 as JAX computes it."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resample_time(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Linear resample of ``[B, C, T]`` to ``int(T·scale)`` frames, as
    ``jax.image.resize(method="linear")`` (antialiased when it shrinks;
    unlike ``F.interpolate``, which reads two neighbours)."""
    T = x.shape[-1]
    n = int(T * scale)
    if n == T:
        return x
    w = torch.as_tensor(_resample_matrix(T, n), dtype=x.dtype, device=x.device)
    return x @ w


def gelu(x):
    """flax's ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class ResidualBlock(nn.Module):
    """``n`` × (LayerNorm, dilated conv to ``c_multiple·C``, GELU, 1×1
    projection back, residual add); no biases."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: int = 1, n: int = 2,
                 c_multiple: int = 2):
        super().__init__()
        self.n = n
        for i in range(n):
            self.add_module(f"norm_{i}", ChannelLayerNorm(channels, eps=FLAX_LN_EPS))
            self.add_module(f"conv_{i}", PadConv1d(
                channels, c_multiple * channels, kernel_size, dilation=dilation,
                pad=same_padding(kernel_size, dilation), bias=False))
            self.add_module(f"proj_{i}", PadConv1d(c_multiple * channels, channels, 1,
                                                   bias=False))

    def forward(self, x):
        for i in range(self.n):
            h = getattr(self, f"conv_{i}")(getattr(self, f"norm_{i}")(x))
            x = x + getattr(self, f"proj_{i}")(gelu(h))
        return x


class ConvBlocks(nn.Module):
    """Residual blocks, a last norm and the output conv; all-zero (padding)
    frames are zeroed again after every stage. ``in_channels`` other than
    ``channels`` adds the 1×1 ``in_proj``."""

    def __init__(self, channels: int, out_dims: int, dilations, kernel_size: int = 3,
                 layers_in_block: int = 2, c_multiple: int = 2, in_channels: int | None = None):
        super().__init__()
        in_channels = channels if in_channels is None else in_channels
        if in_channels != channels:
            self.in_proj = PadConv1d(in_channels, channels, 1, bias=False)
        self.n_res = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"res_{i}", ResidualBlock(channels, kernel_size, d,
                                                      layers_in_block, c_multiple))
        self.last_norm = ChannelLayerNorm(channels, eps=FLAX_LN_EPS)
        self.post = PadConv1d(channels, out_dims, 3, pad=same_padding(3), bias=False)

    def forward(self, x):
        nonpadding = (x.abs().sum(dim=1, keepdim=True) > 0).to(x.dtype)
        if hasattr(self, "in_proj"):
            x = self.in_proj(x)
        for i in range(self.n_res):
            x = getattr(self, f"res_{i}")(x) * nonpadding
        x = self.last_norm(x) * nonpadding
        return self.post(x) * nonpadding


def _with_style(x, sty):
    """Append the style vector ``[B, S]`` to every frame of ``[B, C, T]``."""
    return torch.cat([x, sty[:, :, None].expand(-1, -1, x.shape[2])], dim=1)


class ResBlocksBackbone(nn.Module):
    """T → T/2 conv backbone with the style appended at the bottleneck."""

    def __init__(self, in_dim: int, sty_dim: int = 256, out_dim: int = 512,
                 dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        self.rb0 = ConvBlocks(in_dim, 64, [1] * 3)
        self.rb1 = ConvBlocks(64, 128, [1] * 4)
        self.rb2 = ConvBlocks(128, 256, [1] * 14)
        self.rb3 = ConvBlocks(512, 512, [1] * 3, in_channels=256 + sty_dim)
        self.rb4 = ConvBlocks(512, out_dim, [1] * 3)

    def forward(self, x, sty, x_mask):
        """x [B, C, T], sty [B, S], x_mask [B, 1, T] → (x [B, out, T/2], mask)."""
        m = x_mask
        x = self.rb0(x) * m
        x, m = resample_time(x, 0.5), resample_time(m, 0.5)
        x = self.rb1(x * m) * m
        x = self.rb2(x) * m
        x = F.dropout(x, self.dropout, self.training)
        x = self.rb3(_with_style(x, sty)) * m
        return self.rb4(x) * m, m


class ResNetBackbone(nn.Module):
    """T → T/8 → T/2 encoder/decoder."""

    def __init__(self, in_dim: int, sty_dim: int = 256, out_dim: int = 512,
                 dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        self.rb0 = ConvBlocks(in_dim, 64, [1] * 3)
        self.rb1 = ConvBlocks(64, 128, [1] * 4)
        self.rb2 = ConvBlocks(128, 256, [1] * 14)
        self.rb3 = ConvBlocks(512, 512, [1] * 3, in_channels=256 + sty_dim)
        self.rb4 = ConvBlocks(512, out_dim, [1] * 3)

    def forward(self, x, sty, x_mask):
        m = x_mask
        x = self.rb0(x) * m
        x, m = resample_time(x, 0.5), resample_time(m, 0.5)
        x = self.rb1(x * m) * m
        x, m = resample_time(x, 0.5), resample_time(m, 0.5)
        x = self.rb2(x * m) * m
        x, m = resample_time(x, 0.5), resample_time(m, 0.5)
        x = F.dropout(x * m, self.dropout, self.training)
        x = self.rb3(_with_style(x, sty)) * m
        x, m = resample_time(x, 4.0), resample_time(m, 4.0)
        return self.rb4(x * m) * m, m


class UNetBackbone(nn.Module):
    """U-Net (T → T/8 → T/2) with skip concatenation; dropout on the
    bottleneck and on both skips."""

    def __init__(self, in_dim: int, sty_dim: int = 256, out_dim: int = 512,
                 dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        self.rb0 = ConvBlocks(in_dim, 64, [1] * 3)
        self.rb1 = ConvBlocks(64, 128, [1] * 4)
        self.rb2 = ConvBlocks(128, 256, [1] * 8)
        self.rb3 = ConvBlocks(512, 512, [1] * 3, in_channels=256 + sty_dim)
        self.rb4 = ConvBlocks(768, 512, [1] * 3)
        self.rb5 = ConvBlocks(640, out_dim, [1] * 3)

    def forward(self, x, sty, x_mask):
        def drop(t):
            return F.dropout(t, self.dropout, self.training)

        m = x_mask
        x0 = self.rb0(x) * m
        m1 = resample_time(m, 0.5)
        x1 = self.rb1(resample_time(x0, 0.5) * m1) * m1
        m2 = resample_time(m1, 0.5)
        x2 = self.rb2(resample_time(x1, 0.5) * m2) * m2
        m3 = resample_time(m2, 0.5)
        x = drop(resample_time(x2, 0.5) * m3)
        x3 = self.rb3(_with_style(x, sty)) * m3
        x = resample_time(x3, 2.0) * m2
        x4 = self.rb4(torch.cat([x, drop(x2)], dim=1)) * m2  # 512 + 256
        x = resample_time(x4, 2.0) * m1
        return self.rb5(torch.cat([x, drop(x1)], dim=1)) * m1, m1  # 512 + 128


class SeqLevelConvolutionalModel(nn.Module):
    """Audio (+ energy) encoder, style encoder, backbone and output head:
    landmark frames at half the input rate ``[B, T/2, out_dim]``."""

    def __init__(self, out_dim: int = 64, audio_feat_type: str = "ppg",
                 backbone_type: str = "unet", dropout: float = 0.5, audio_dim: int = 29,
                 energy_dim: int = 1, mel_dim: int = 80, style_dim: int = 135):
        super().__init__()
        self.audio_feat_type = audio_feat_type
        self.style_0 = nn.Linear(style_dim, 256)
        self.style_1 = nn.Linear(256, 256)
        if audio_feat_type == "ppg":
            encs = {"audio_enc": (audio_dim, 48), "energy_enc": (energy_dim, 16)}
        elif audio_feat_type == "mel":
            encs = {"mel_enc": (mel_dim, 64)}
        else:
            raise ValueError(audio_feat_type)
        for name, (cin, ch) in encs.items():
            self.add_module(f"{name}_0", PadConv1d(cin, ch, 3, pad=same_padding(3), bias=False))
            self.add_module(f"{name}_ln", ChannelLayerNorm(ch, eps=FLAX_LN_EPS))
            self.add_module(f"{name}_1", PadConv1d(ch, ch, 3, pad=same_padding(3), bias=False))
        self.encoders = tuple(encs)
        backbone = {"unet": UNetBackbone, "resnet": ResNetBackbone,
                    "resblocks": ResBlocksBackbone}[backbone_type]
        self.backbone = backbone(64, 256, dropout=dropout)
        self.out_ln = ChannelLayerNorm(512, eps=FLAX_LN_EPS)
        self.out_0 = PadConv1d(512, 64, 3, pad=same_padding(3), bias=False)
        self.out_prelu = nn.PReLU(1, init=0.01)
        self.out_1 = PadConv1d(64, out_dim, 3, pad=same_padding(3), bias=False)

    def _enc(self, name, x):
        h = getattr(self, f"{name}_0")(x)
        return getattr(self, f"{name}_1")(gelu(getattr(self, f"{name}_ln")(h)))

    def forward(self, batch: dict):
        """→ (out [B, T/2, out_dim], out_mask [B, T/2])."""
        x_mask = batch["x_mask"][:, None]  # [B, 1, T]
        sty = self.style_1(gelu(self.style_0(batch["style"])))
        keys = {"audio_enc": "audio", "energy_enc": "energy", "mel_enc": "mel"}
        feat = torch.cat([self._enc(n, batch[keys[n]].transpose(1, 2)) * x_mask
                          for n in self.encoders], dim=1)
        feat, out_mask = self.backbone(feat, sty, x_mask)
        h = self.out_prelu(self.out_0(self.out_ln(feat)))
        out = self.out_1(h) * out_mask
        return out.transpose(1, 2), out_mask[:, 0]
