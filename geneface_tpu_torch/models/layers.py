"""Layers shared by the audio-side models (HuBERT, the Audio2Motion VAE and
its flow prior, the post-net), with flax's conventions where they differ
from torch's defaults.

The models built from these name their submodules as the flax modules are
named in the JAX checkpoints (``Conv_0``, ``pre_0``, ``layer_3``, ...), so
that :func:`geneface_tpu_torch.convert.load_flax_variables` maps a
checkpoint onto a model by name and type alone.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "PadConv1d",
    "ChannelLayerNorm",
    "FrozenBatchNorm1d",
    "FrozenBatchNorm2d",
    "same_padding",
    "channel_norm",
    "train_running_stats_",
    "init_weights_",
]

#: flax ``nn.LayerNorm()``'s default epsilon (torch's is 1e-5)
FLAX_LN_EPS = 1e-6


def same_padding(kernel: int, dilation: int = 1) -> tuple:
    """flax ``padding="SAME"`` at stride 1: the extra step of an even total
    goes to the right."""
    total = dilation * (kernel - 1)
    return total // 2, total - total // 2


class PadConv1d(nn.Conv1d):
    """``Conv1d`` on channel-first ``[B, C, T]`` with flax's explicit
    ``(left, right)`` padding applied first (``(0, 0)`` is ``VALID``)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 pad: tuple = (0, 0), dilation: int = 1, groups: int = 1,
                 bias: bool = True):
        super().__init__(cin, cout, kernel, stride=stride, dilation=dilation,
                         groups=groups, bias=bias)
        self.pad = tuple(pad)

    def forward(self, x):
        if any(self.pad):
            x = F.pad(x, self.pad)
        return super().forward(x)


class ChannelLayerNorm(nn.LayerNorm):
    """LayerNorm over the channels of a channel-first ``[B, C, T]`` input."""

    def forward(self, x):
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class FrozenBatchNorm1d(nn.BatchNorm1d):
    """Eval-mode BatchNorm on ``[B, C, T]`` whatever the module's mode: flax
    ``BatchNorm(use_running_average=True, epsilon=1e-5)``. After
    :func:`train_running_stats_` the running statistics are parameters and
    the forward is flax's arithmetic, differentiable in them."""

    def forward(self, x):
        if isinstance(self.running_var, nn.Parameter):
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return (x - self.running_mean[:, None]) * mul[:, None] + self.bias[:, None]
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, training=False, eps=self.eps)


def train_running_stats_(model: nn.Module) -> nn.Module:
    """Make the running mean and variance of every
    :class:`FrozenBatchNorm1d` of ``model`` trainable parameters (same
    names, same values): the JAX SyncNet task hands its whole variables
    tree, ``batch_stats`` included, to Adam, so the frozen statistics of
    ``syncnet_norm: bn`` get gradients and move."""
    for m in model.modules():
        if isinstance(m, FrozenBatchNorm1d):
            for name in ("running_mean", "running_var"):
                t = m._buffers.pop(name)
                m.register_parameter(name, nn.Parameter(t.detach().clone()))
    return model


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """Eval-mode BatchNorm on ``[B, C, H, W]`` whatever the module's mode
    (the datagen networks' frozen running statistics)."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, training=False, eps=self.eps)


def channel_norm(norm: str, channels: int) -> nn.Module:
    """The ``norm`` of the VAE's condition encoder and the post-net blocks:
    ``"ln"`` (flax ``LayerNorm()``, epsilon 1e-6) or ``"bn"`` (frozen
    running statistics, epsilon 1e-5)."""
    if norm == "bn":
        return FrozenBatchNorm1d(channels, eps=1e-5)
    return ChannelLayerNorm(channels, eps=FLAX_LN_EPS)


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter from ``generator`` (on the CPU; move the model
    afterwards): weights and biases of convolutions and dense layers
    uniform in ``±1/sqrt(fan_in)``, embeddings standard normal, norm scales
    ``1 ± 0.1`` and shifts ``±0.1``, running means ``±0.1`` and variances
    in ``[0.5, 1.5]``. Every leaf is random, the flow couplings' output
    convolutions too (flax initializes those to zero, which makes the prior
    flow the identity)."""

    def uniform_(t, bound):
        t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1) * bound)

    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d, nn.Conv2d, nn.Linear)):
            w = m.weight
            fan_in = w.shape[1] * math.prod(w.shape[2:])
            if isinstance(m, nn.ConvTranspose1d):  # weight [Cin, Cout, K]
                fan_in = w.shape[0]
            bound = 1.0 / math.sqrt(fan_in)
            uniform_(w, bound)
            if m.bias is not None:
                uniform_(m.bias, bound)
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm1d, nn.BatchNorm2d)):
            m.weight.copy_(1 + (torch.rand(m.weight.shape, generator=generator) * 2 - 1) * 0.1)
            uniform_(m.bias, 0.1)
            if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
                uniform_(m.running_mean, 0.1)
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=generator))
    return model
