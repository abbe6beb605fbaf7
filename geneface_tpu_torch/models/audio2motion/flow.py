"""Normalizing flows (port of ``geneface_tpu/models/audio2motion/flow.py``):
the VAE's prior — the gated dilated-conv stack ``WN``, the mean-only
``ResidualCouplingLayer``, the ``ResidualCouplingBlock`` of couplings and
flips, and ``Flip`` — and the Glow stack: ``ActNorm``, the grouped
invertible 1×1 ``InvConvNear``, the affine ``CouplingBlock`` and ``Glow``
(with its time squeeze), each returning ``(z, logdet)``.

Layout: channel-first, the torch idiom of the original GeneFace modules —
``x [B, C, T]``, masks ``[B, 1, T]``, conditions ``g [B, C_g, T]`` (the JAX
package is channel-last). Submodules carry the flax names (``in_<i>``,
``res_skip_<i>``, ``cond_layer``, ``pre``, ``enc``, the couplings' output
``Conv_0``, ``couplings_<i>``, ``start``, ``wn``, ``actnorms_<i>``,
``invconvs_<i>``). No weight norm, as in the JAX package. The Glow stack
keeps the JAX package's channel-last orders where they matter: the
invertible 1×1 mixes the groups ``(2, C/S, S/2)`` of the channel-last
layout, and the squeeze interleaves ``n`` frames as ``(frame, channel)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from geneface_tpu_torch.models.layers import PadConv1d, same_padding

__all__ = ["WN", "ResidualCouplingLayer", "ResidualCouplingBlock", "Flip", "ActNorm",
           "InvConvNear", "CouplingBlock", "Glow"]


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


class ActNorm(nn.Module):
    """Per-channel affine with its logdet (zero init: the identity)."""

    def __init__(self, channels: int):
        super().__init__()
        self.logs = nn.Parameter(torch.zeros(1, channels, 1))
        self.bias = nn.Parameter(torch.zeros(1, channels, 1))
        self.flax_leaves = {"logs": (1, 1, channels), "bias": (1, 1, channels)}

    def forward(self, x, x_mask=None, g=None, reverse: bool = False):
        if x_mask is None:
            x_mask = torch.ones_like(x[:, :1])
        x_len = x_mask.sum(dim=(1, 2))
        if reverse:
            return (x - self.bias) * torch.exp(-self.logs) * x_mask, -self.logs.sum() * x_len
        return (self.bias + torch.exp(self.logs) * x) * x_mask, self.logs.sum() * x_len


class InvConvNear(nn.Module):
    """Invertible 1×1 mixing of ``n_split`` channel groups: the channels
    split as ``(2, C/S, S/2)``, the ``S``-sized axis ``(2, S/2)`` mixed by
    the ``[S, S]`` weight (``slogdet`` and ``inv`` on it)."""

    def __init__(self, channels: int, n_split: int = 4):
        super().__init__()
        self.channels, self.n_split = channels, n_split
        q, _ = torch.linalg.qr(torch.randn(n_split, n_split))
        if torch.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        self.weight = nn.Parameter(q)
        self.flax_leaves = {"weight": (n_split, n_split)}

    def forward(self, x, x_mask=None, g=None, reverse: bool = False):
        B, C, T = x.shape
        S = self.n_split
        if x_mask is None:
            x_mask = torch.ones(B, 1, T, dtype=x.dtype, device=x.device)
        x_len = x_mask.sum(dim=(1, 2))
        xg = x.reshape(B, 2, C // S, S // 2, T).transpose(2, 3).reshape(B, S, C // S, T)
        w = torch.linalg.inv(self.weight) if reverse else self.weight
        z = torch.einsum("bsct,ks->bkct", xg, w)
        z = z.reshape(B, 2, S // 2, C // S, T).transpose(2, 3).reshape(B, C, T) * x_mask
        logabsdet = torch.linalg.slogdet(self.weight)[1]
        return z, (-1.0 if reverse else 1.0) * logabsdet * (C / S) * x_len


class CouplingBlock(nn.Module):
    """Affine coupling of the channel halves with a ``WN`` core (its
    output convolution ``Conv_0`` zero-initialized in flax)."""

    def __init__(self, in_channels: int, hidden_channels: int, kernel_size: int = 3,
                 dilation_rate: int = 1, n_layers: int = 4, gin_channels: int = 0,
                 sigmoid_scale: bool = False):
        super().__init__()
        self.half = in_channels // 2
        self.sigmoid_scale = sigmoid_scale
        self.start = PadConv1d(self.half, hidden_channels, 1)
        self.wn = WN(hidden_channels, kernel_size, dilation_rate, n_layers, gin_channels)
        self.Conv_0 = PadConv1d(hidden_channels, in_channels, 1)

    def forward(self, x, x_mask=None, g=None, reverse: bool = False):
        if x_mask is None:
            x_mask = torch.ones_like(x[:, :1])
        x0, x1 = x[:, : self.half], x[:, self.half :]
        h = self.wn(self.start(x0) * x_mask, x_mask, g)
        out = self.Conv_0(h)
        m, logs = out[:, : self.half], out[:, self.half :]
        if self.sigmoid_scale:
            logs = torch.log(1e-6 + torch.sigmoid(logs + 2))
        if reverse:
            z1 = (x1 - m) * torch.exp(-logs) * x_mask
            logdet = -(logs * x_mask).sum(dim=(1, 2))
        else:
            z1 = (m + torch.exp(logs) * x1) * x_mask
            logdet = (logs * x_mask).sum(dim=(1, 2))
        return torch.cat([x0, z1], dim=1), logdet


class Glow(nn.Module):
    """``n_blocks`` × (ActNorm, InvConvNear, CouplingBlock) on the
    time-squeezed sequence; ``reverse`` runs them backwards."""

    def __init__(self, in_channels: int, hidden_channels: int, kernel_size: int = 3,
                 dilation_rate: int = 1, n_blocks: int = 4, n_layers: int = 4,
                 n_split: int = 4, n_sqz: int = 2, gin_channels: int = 0,
                 sigmoid_scale: bool = False):
        super().__init__()
        self.n_blocks, self.n_sqz = n_blocks, n_sqz
        ch = in_channels * n_sqz
        for i in range(n_blocks):
            self.add_module(f"actnorms_{i}", ActNorm(ch))
            self.add_module(f"invconvs_{i}", InvConvNear(ch, n_split))
            self.add_module(f"couplings_{i}", CouplingBlock(
                ch, hidden_channels, kernel_size, dilation_rate, n_layers,
                gin_channels * n_sqz, sigmoid_scale))

    def _squeeze(self, x, T2):
        """``[B, C, T]`` → ``[B, n·C, T2/n]``, channel ``j·C + c`` holding
        frame ``n·t + j`` (the JAX layout's ``(frame, channel)`` order)."""
        B, C = x.shape[:2]
        n = self.n_sqz
        return x[:, :, :T2].reshape(B, C, T2 // n, n).permute(0, 3, 1, 2).reshape(B, n * C, -1)

    def forward(self, x, x_mask=None, g=None, reverse: bool = False):
        """x [B, C, T], x_mask [B, 1, T], g [B, C_g, T] → (z [B, C, T],
        logdet [B])."""
        B, C, T = x.shape
        n = self.n_sqz
        if x_mask is None:
            x_mask = torch.ones(B, 1, T, dtype=x.dtype, device=x.device)
        if n > 1:
            T2 = (T // n) * n
            x = self._squeeze(x, T2)
            if g is not None:
                g = self._squeeze(g, T2)
            x_mask = x_mask[:, :, n - 1 : T2 : n]
        logdet_tot = torch.zeros(B, dtype=x.dtype, device=x.device)
        order = reversed(range(self.n_blocks)) if reverse else range(self.n_blocks)
        for i in order:
            stages = [getattr(self, f"{k}_{i}") for k in ("actnorms", "invconvs", "couplings")]
            for stage in (reversed(stages) if reverse else stages):
                x, logdet = stage(x, x_mask, g=g, reverse=reverse)
                logdet_tot = logdet_tot + logdet
        if n > 1:
            T2 = x.shape[2]
            x = x.reshape(B, n, C, T2).permute(0, 2, 3, 1).reshape(B, C, T2 * n)
            x = F.pad(x, (0, T - x.shape[2]))
        return x, logdet_tot
