"""Multi-window 1-D discriminators for adversarial landmark-sequence training
(port of ``geneface_tpu/models/audio2motion/discriminators.py``):
``Discriminator1DFactory`` (a strided conv tower per window length),
``CosineDiscriminator1DFactory`` (two towers compared by cosine),
``MultiWindowDiscriminator`` (clips at several window lengths from given
starts, validities summed) and the mel-conditioned ``Discriminator``.

Layout: the models take and return channel-last tensors (``x [B, T, C]``,
hiddens ``[B, T', C]``) as the JAX package does; the towers run
channel-first and transpose back before they flatten, so that the dense
layer after a tower reads ``(frame, channel)`` in the JAX order and
converted weights line up. Submodules carry the flax names (``Conv_<i>``,
``LayerNorm_<i>``, ``Dense_<i>``, ``a_conv<i>``, ``factories_<i>``, ...).
Convolutions take stride 2 and padding ``(k//2, k//2)``; LayerNorm's
epsilon is flax's 1e-6; dropout follows the module's ``training`` flag.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from geneface_tpu_torch.models.layers import FLAX_LN_EPS, ChannelLayerNorm, PadConv1d, same_padding

__all__ = [
    "Discriminator1DFactory",
    "CosineDiscriminator1DFactory",
    "MultiWindowDiscriminator",
    "Discriminator",
]


def _strided_len(T: int, k: int) -> int:
    """Frames after a stride-2 conv of kernel ``k`` padded ``(k//2, k//2)``."""
    return (T + 2 * (k // 2) - k) // 2 + 1


def _act(h, training: bool):
    return F.dropout(F.leaky_relu(h, 0.2), 0.25, training)


def _flat(h):
    """Channel-first ``[B, C, T']`` → ``[B, T'·C]`` in channel-last order."""
    return h.transpose(1, 2).reshape(h.shape[0], -1)


class Discriminator1DFactory(nn.Module):
    """Validity ``[B, 1]`` of a ``time_length``-frame clip and the tower's
    hiddens: three strided convs (``time_length >= 8``), a 3-frame conv and
    two 1×1 convs (3), or two dense layers and a sigmoid (1)."""

    def __init__(self, time_length: int, kernel_size: int = 3, in_dim: int = 64,
                 hidden_size: int = 128):
        super().__init__()
        self.time_length = time_length
        k, H = kernel_size, hidden_size
        if time_length >= 8:
            T = time_length
            for i in range(3):
                self.add_module(f"Conv_{i}", PadConv1d(in_dim if i == 0 else H, H, k, stride=2,
                                                       pad=(k // 2, k // 2)))
                T = _strided_len(T, k)
            for i in range(2):
                self.add_module(f"LayerNorm_{i}", ChannelLayerNorm(H, eps=FLAX_LN_EPS))
            self.Dense_0 = nn.Linear(T * H, 1)
        elif time_length == 3:
            self.Conv_0 = PadConv1d(in_dim, H, 3)
            self.Conv_1 = PadConv1d(H, H, 1)
            self.Conv_2 = PadConv1d(H, H, 1)
            self.LayerNorm_0 = ChannelLayerNorm(H, eps=FLAX_LN_EPS)
            self.LayerNorm_1 = ChannelLayerNorm(H, eps=FLAX_LN_EPS)
            self.Dense_0 = nn.Linear(H, 1)
        elif time_length == 1:
            self.Dense_0 = nn.Linear(in_dim, H)
            self.Dense_1 = nn.Linear(H, H)
            self.Dense_2 = nn.Linear(H, 1)
        else:
            raise ValueError(f"unsupported time_length {time_length}")

    def forward(self, x):
        """x [B, T, C] → (validity [B, 1], hiddens [B, T', H] list)."""
        if self.time_length == 1:
            h = x.reshape(x.shape[0], -1)
            for i in range(2):
                h = _act(getattr(self, f"Dense_{i}")(h), self.training)
            return torch.sigmoid(self.Dense_2(h)), [h]
        h, hs = x.transpose(1, 2), []
        if self.time_length >= 8:
            for i in range(3):
                h = _act(getattr(self, f"Conv_{i}")(h), self.training)
                if i > 0:
                    h = getattr(self, f"LayerNorm_{i - 1}")(h)
                hs.append(h)
        else:
            h = _act(self.Conv_0(h), self.training)
            for i in range(2):
                h = getattr(self, f"LayerNorm_{i}")(_act(getattr(self, f"Conv_{i + 1}")(h),
                                                         self.training))
            hs.append(h)
        return self.Dense_0(_flat(h)), [t.transpose(1, 2) for t in hs]


class CosineDiscriminator1DFactory(nn.Module):
    """Two strided conv towers (``a``, ``b``); the validity is the cosine
    of their flattened outputs (norms floored at 1e-8)."""

    def __init__(self, time_length: int, kernel_size: int = 3, in_dim: int = 64,
                 hidden_size: int = 128):
        super().__init__()
        k, H = kernel_size, hidden_size
        for t in ("a", "b"):
            for i in range(3):
                self.add_module(f"{t}_conv{i}", PadConv1d(in_dim if i == 0 else H, H, k,
                                                          stride=2, pad=(k // 2, k // 2)))
            for i in (1, 2):
                self.add_module(f"{t}_ln{i}", ChannelLayerNorm(H, eps=FLAX_LN_EPS))

    def _tower(self, x, t):
        h, hs = x.transpose(1, 2), []
        for i in range(3):
            h = _act(getattr(self, f"{t}_conv{i}")(h), self.training)
            if i > 0:
                h = getattr(self, f"{t}_ln{i}")(h)
            hs.append(h.transpose(1, 2))
        return _flat(h), hs

    def forward(self, x1, x2):
        (f1, h1), (f2, h2) = self._tower(x1, "a"), self._tower(x2, "b")
        f1 = f1 / f1.norm(dim=-1, keepdim=True).clamp(min=1e-8)
        f2 = f2 / f2.norm(dim=-1, keepdim=True).clamp(min=1e-8)
        return (f1 * f2).sum(dim=-1, keepdim=True), h1 + h2


class MultiWindowDiscriminator(nn.Module):
    """One factory per window length over clips that start at the given
    frames (clamped to ``[0, T − window]``); with a condition, each clip and
    its condition are projected to 64 channels first (summed, or compared by
    the cosine factories)."""

    def __init__(self, time_lengths=(8, 16, 32), cond_dim: int = 64, in_dim: int = 64,
                 kernel_size: int = 3, hidden_size: int = 128, disc_type: str = "standard"):
        super().__init__()
        self.time_lengths = tuple(time_lengths)
        self.cond_dim, self.disc_type = cond_dim, disc_type
        factory = (Discriminator1DFactory if disc_type == "standard"
                   else CosineDiscriminator1DFactory)
        tower_in = 64 if cond_dim > 0 else in_dim
        for i, t in enumerate(self.time_lengths):
            self.add_module(f"factories_{i}", factory(t, kernel_size, tower_in, hidden_size))
            if cond_dim > 0:
                self.add_module(f"cond_projs_{i}", nn.Linear(cond_dim, 64))
                self.add_module(f"in_projs_{i}", nn.Linear(in_dim, 64))

    def forward(self, x, x_len, cond=None, start_frames=None):
        """x [B, T, C]; x_len [B] (unused, as in the JAX package); cond
        [B, T, C_c]; start_frames: one start per window (host ints)."""
        validity = 0.0
        T = x.shape[1]
        for i, win in enumerate(self.time_lengths):
            start = 0 if start_frames is None else int(start_frames[i])
            start = max(0, min(start, T - win))
            x_clip = x[:, start : start + win]
            c_clip = cond[:, start : start + win] if cond is not None else None
            factory = getattr(self, f"factories_{i}")
            if self.cond_dim > 0 and c_clip is not None:
                xi = getattr(self, f"in_projs_{i}")(x_clip)
                ci = getattr(self, f"cond_projs_{i}")(c_clip)
                v, _ = factory(xi, ci) if self.disc_type == "cosine" else factory(xi + ci)
            else:
                v, _ = factory(x_clip)
            validity = validity + v
        return validity


class Discriminator(nn.Module):
    """The landmark-sequence discriminator conditioned on HuBERT (or mel)
    frames at twice the landmark rate, taken every other frame."""

    def __init__(self, x_dim: int = 1024, y_dim: int = 64, time_lengths=(8, 16, 32),
                 disc_type: str = "standard", uncond_disc: bool = False, hidden_size: int = 128):
        super().__init__()
        self.uncond_disc = uncond_disc
        if not uncond_disc:
            self.mel_conv1 = PadConv1d(x_dim, 64, 3, pad=same_padding(3), bias=False)
            self.mel_ln = ChannelLayerNorm(64, eps=FLAX_LN_EPS)
            self.mel_conv2 = PadConv1d(64, 64, 3, pad=same_padding(3), bias=False)
        self.disc = MultiWindowDiscriminator(time_lengths, in_dim=y_dim,
                                             cond_dim=0 if uncond_disc else 64,
                                             hidden_size=hidden_size, disc_type=disc_type)

    def forward(self, x, mel=None, start_frames=None):
        """x [B, T, C_y] landmarks; mel [B, 2T, C_x] → validity [B, 1]."""
        cond = None
        if not self.uncond_disc:
            m = mel[:, ::2].transpose(1, 2)
            m = self.mel_conv2(F.gelu(self.mel_ln(self.mel_conv1(m)), approximate="tanh"))
            cond = m.transpose(1, 2)
        x_len = ((x.abs().sum(-1)) != 0).sum(-1)
        return self.disc(x, x_len, cond, start_frames)
