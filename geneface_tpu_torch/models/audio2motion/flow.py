"""The VAE's flow prior (port of the parts of
``geneface_tpu/models/audio2motion/flow.py`` that it uses): the gated
dilated-conv stack ``WN``, the mean-only ``ResidualCouplingLayer``, the
``ResidualCouplingBlock`` of couplings and flips, and ``Flip``.

Layout: channel-first, the torch idiom of the original GeneFace modules —
``x [B, C, T]``, masks ``[B, 1, T]``, conditions ``g [B, C_g, T]`` (the JAX
package is channel-last). Submodules carry the flax names (``in_<i>``,
``res_skip_<i>``, ``cond_layer``, ``pre``, ``enc``, the couplings' output
``Conv_0``, ``couplings_<i>``). No weight norm, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from geneface_tpu_torch.models.layers import PadConv1d, same_padding

__all__ = ["WN", "ResidualCouplingLayer", "ResidualCouplingBlock", "Flip"]


class WN(nn.Module):
    """Gated dilated conv stack with 1×1 conditioning."""

    def __init__(self, hidden_channels: int, kernel_size: int = 3, dilation_rate: int = 1,
                 n_layers: int = 5, gin_channels: int = 0):
        super().__init__()
        H = self.hidden = hidden_channels
        self.n_layers = n_layers
        if gin_channels:
            self.cond_layer = PadConv1d(gin_channels, 2 * H * n_layers, 1)
        for i in range(n_layers):
            d = dilation_rate**i
            self.add_module(f"in_{i}", PadConv1d(H, 2 * H, kernel_size, dilation=d,
                                                 pad=same_padding(kernel_size, d)))
            self.add_module(f"res_skip_{i}",
                            PadConv1d(H, 2 * H if i < n_layers - 1 else H, 1))

    def forward(self, x, x_mask=None, g=None):
        """x [B, H, T]; x_mask [B, 1, T] or None; g [B, C_g, T] or None."""
        H = self.hidden
        if x_mask is None:
            x_mask = torch.ones_like(x[:, :1])
        g_all = self.cond_layer(g) if g is not None and hasattr(self, "cond_layer") else None
        output = torch.zeros_like(x)
        for i in range(self.n_layers):
            acts = getattr(self, f"in_{i}")(x)
            if g_all is not None:
                acts = acts + g_all[:, i * 2 * H : (i + 1) * 2 * H]
            acts = torch.tanh(acts[:, :H]) * torch.sigmoid(acts[:, H:])
            res_skip = getattr(self, f"res_skip_{i}")(acts)
            if i < self.n_layers - 1:
                x = (x + res_skip[:, :H]) * x_mask
                output = output + res_skip[:, H:]
            else:
                output = output + res_skip
        return output * x_mask


class ResidualCouplingLayer(nn.Module):
    """Half-channel coupling, mean-only: ``x1 ← x1 ± m(x0)``."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int = 3,
                 dilation_rate: int = 1, n_layers: int = 4, gin_channels: int = 0):
        super().__init__()
        self.half = channels // 2
        self.pre = PadConv1d(self.half, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers, gin_channels)
        self.Conv_0 = PadConv1d(hidden_channels, self.half, 1)  # zero-initialized in flax

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x0, x1 = x[:, : self.half], x[:, self.half :]
        h = self.pre(x0) * x_mask
        m = self.Conv_0(self.enc(h, x_mask, g)) * x_mask
        x1 = (x1 - m if reverse else m + x1) * x_mask
        return torch.cat([x0, x1], dim=1)


class Flip(nn.Module):
    """Reverse the channel order (its own inverse)."""

    def forward(self, x, x_mask=None, g=None, reverse: bool = False):
        return torch.flip(x, dims=[1])


class ResidualCouplingBlock(nn.Module):
    """``n_flows`` × (coupling, flip); ``reverse`` runs flip then coupling,
    last flow first."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int = 3,
                 dilation_rate: int = 1, n_layers: int = 4, n_flows: int = 4,
                 gin_channels: int = 0):
        super().__init__()
        self.n_flows = n_flows
        for i in range(n_flows):
            self.add_module(f"couplings_{i}", ResidualCouplingLayer(
                channels, hidden_channels, kernel_size, dilation_rate, n_layers, gin_channels))
        self.flip = Flip()

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        order = reversed(range(self.n_flows)) if reverse else range(self.n_flows)
        for i in order:
            coupling = getattr(self, f"couplings_{i}")
            if reverse:
                x = coupling(self.flip(x), x_mask, g=g, reverse=True)
            else:
                x = self.flip(coupling(x, x_mask, g=g))
        return x
