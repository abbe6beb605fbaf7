"""Transformer sequence stacks (port of
``geneface_tpu/models/audio2motion/transformer.py``): sinusoidal positions,
the pre-LN self-attention + conv-FFN ``TransformerEncoderLayer``,
``FFTBlocks`` and the style-fusion generator
``TransformerStyleFusionModel``.

Layout: ``[B, T, C]`` end to end, as the JAX package (and torch's
``batch_first`` transformers); the FFN's convolution runs channel-first.
The attention is flax's ``MultiHeadDotProductAttention`` written out as
products: ``query``/``key``/``value`` projections to ``[heads, head_dim]``
(``DenseGeneral`` kernels ``[in, heads, head_dim]``, which
:mod:`geneface_tpu_torch.convert` maps onto the ``Linear`` layers here),
the query scaled by ``head_dim^-½``, masked logits filled with the dtype's
most negative finite value (so a row whose keys are all padding averages
them uniformly instead of turning to NaN), softmax, and the ``out``
projection from ``[heads, head_dim]``. flax's LayerNorm epsilon 1e-6;
PReLU's slope one scalar from 0.01. Dropout follows the module's
``training`` flag.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from geneface_tpu_torch.models.layers import FLAX_LN_EPS, PadConv1d, same_padding

__all__ = [
    "sinusoidal_positions",
    "MultiHeadAttention",
    "TransformerEncoderLayer",
    "FFTBlocks",
    "TransformerStyleFusionModel",
]


def sinusoidal_positions(T: int, dim: int) -> np.ndarray:
    """fairseq-convention sinusoidal table ``[T, dim]``: sin on the first
    half, cos on the second, a zero column when ``dim`` is odd."""
    half = dim // 2
    emb = np.log(10000.0) / max(half - 1, 1)
    freqs = np.exp(np.arange(half, dtype=np.float32) * -emb)
    args = np.arange(T, dtype=np.float32)[:, None] * freqs[None, :]
    table = np.concatenate([np.sin(args), np.cos(args)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((T, 1), np.float32)], axis=1)
    return table


class _HeadsLinear(nn.Linear):
    """A ``Linear`` whose flax ``DenseGeneral`` kernel (and bias) split an
    axis into ``[heads, head_dim]``: ``flax_shapes`` names those shapes."""

    def __init__(self, cin: int, cout: int, kernel_shape: tuple, bias_shape: tuple):
        super().__init__(cin, cout)
        self.flax_shapes = {"kernel": kernel_shape, "bias": bias_shape}


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, a key mask)."""

    def __init__(self, in_features: int, num_heads: int, qkv_features: int | None = None,
                 dropout: float = 0.0):
        super().__init__()
        qkv = qkv_features or in_features
        self.heads, self.head_dim = num_heads, qkv // num_heads
        self.dropout = dropout
        for name in ("query", "key", "value"):
            self.add_module(name, _HeadsLinear(in_features, qkv,
                                               (in_features, num_heads, self.head_dim),
                                               (num_heads, self.head_dim)))
        self.out = _HeadsLinear(qkv, in_features, (num_heads, self.head_dim, in_features),
                                (in_features,))

    def forward(self, x, mask=None):
        """x [B, T, C]; mask [B, T] (True = a key to attend to) → [B, T, C]."""
        B, T, _ = x.shape
        q, k, v = (getattr(self, n)(x).view(B, T, self.heads, self.head_dim)
                   for n in ("query", "key", "value"))
        q = q / math.sqrt(self.head_dim)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            logits = logits.masked_fill(~mask[:, None, None, :], torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits, dim=-1)
        weights = F.dropout(weights, self.dropout, self.training)
        h = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.out(h.reshape(B, T, self.heads * self.head_dim))


class TransformerEncoderLayer(nn.Module):
    """Pre-LN self-attention, then the conv FFN (kernel 9, SAME, with bias
    → ReLU → dense)."""

    def __init__(self, hidden_size: int, num_heads: int = 2, ffn_kernel_size: int = 9,
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.attn_ln = nn.LayerNorm(hidden_size, eps=FLAX_LN_EPS)
        self.self_attn = MultiHeadAttention(hidden_size, num_heads, hidden_size, dropout)
        self.ffn_ln = nn.LayerNorm(hidden_size, eps=FLAX_LN_EPS)
        self.ffn_conv = PadConv1d(hidden_size, 4 * hidden_size, ffn_kernel_size,
                                  pad=same_padding(ffn_kernel_size))
        self.ffn_out = nn.Linear(4 * hidden_size, hidden_size)

    def forward(self, x, nonpadding):
        """x [B, T, C], nonpadding [B, T] floats (1 = keep)."""
        keep = nonpadding[..., None]
        h = self.self_attn(self.attn_ln(x), nonpadding > 0)
        x = (x + h) * keep
        h = self.ffn_conv(self.ffn_ln(x).transpose(1, 2)).transpose(1, 2)
        h = F.dropout(F.relu(h), self.dropout, self.training)
        return (x + self.ffn_out(h)) * keep


class FFTBlocks(nn.Module):
    """Encoder layers over the input plus ``pos_alpha``-scaled sinusoidal
    positions, then a last LayerNorm."""

    def __init__(self, hidden_size: int, num_layers: int, num_heads: int = 2,
                 ffn_kernel_size: int = 9, dropout: float = 0.1, use_pos_embed: bool = True,
                 use_last_norm: bool = True):
        super().__init__()
        self.num_layers, self.dropout = num_layers, dropout
        if use_pos_embed:
            self.pos_alpha = nn.Parameter(torch.ones(1))
            self.flax_leaves = {"pos_alpha": (1,)}
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerEncoderLayer(
                hidden_size, num_heads, ffn_kernel_size, dropout))
        if use_last_norm:
            self.last_ln = nn.LayerNorm(hidden_size, eps=FLAX_LN_EPS)

    def forward(self, x, nonpadding=None):
        """x [B, T, C]; nonpadding [B, T] floats (default: the frames that
        are not all zero)."""
        if nonpadding is None:
            nonpadding = (x.abs().sum(dim=-1) > 0).to(x.dtype)
        if hasattr(self, "pos_alpha"):
            pos = torch.as_tensor(sinusoidal_positions(x.shape[1], x.shape[2]), dtype=x.dtype,
                                  device=x.device)
            x = F.dropout(x + self.pos_alpha * pos[None], self.dropout, self.training)
        x = x * nonpadding[..., None]
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, nonpadding)
        if hasattr(self, "last_ln"):
            x = self.last_ln(x) * nonpadding[..., None]
        return x


class TransformerStyleFusionModel(nn.Module):
    """Audio + energy + style → landmark frames at half rate. ``num_heads``
    is kept for the JAX signature: its ``FFTBlocks`` run their own default
    of 2 heads, as there."""

    def __init__(self, out_dim: int = 64, num_heads: int = 4, dropout: float = 0.1,
                 audio_dim: int = 29, energy_dim: int = 1, style_dim: int = 135):
        super().__init__()
        self.dropout = dropout
        self.audio_0 = nn.Linear(audio_dim, 48)
        self.audio_1 = nn.Linear(48, 128)
        self.energy_0 = nn.Linear(energy_dim, 16)
        self.energy_1 = nn.Linear(16, 64)
        self.backbone1 = FFTBlocks(192, 3, dropout=dropout)
        self.sty_0 = nn.Linear(style_dim, 64)
        self.sty_1 = nn.Linear(64, 128)
        self.backbone2 = FFTBlocks(320, 3, dropout=dropout)
        self.out_0 = nn.Linear(320, out_dim)
        self.out_prelu = nn.PReLU(1, init=0.01)
        self.out_1 = nn.Linear(out_dim, out_dim)

    def forward(self, audio, energy, style, x_mask):
        """audio [B, T, 29], energy [B, T, 1], style [B, 135], x_mask [B, T]
        → [B, T/2, out_dim]."""
        m = x_mask[..., None]
        a = self.audio_0(audio) * m
        a = self.audio_1(F.relu(a)) * m
        e = self.energy_0(energy) * m
        e = self.energy_1(F.relu(e)) * m
        feat = self.backbone1(torch.cat([a, e], dim=-1), x_mask)  # [B, T, 192]
        feat = F.dropout(feat, self.dropout, self.training)
        sty = self.sty_1(F.relu(self.sty_0(style)))
        feat = torch.cat([feat, sty[:, None].expand(-1, feat.shape[1], -1)], dim=-1)
        feat = self.backbone2(feat, x_mask)  # [B, T, 320]
        T2 = feat.shape[1] // 2
        pooled = 0.5 * (feat[:, : 2 * T2 : 2] + feat[:, 1 : 2 * T2 : 2])
        return self.out_1(self.out_prelu(self.out_0(pooled)))
