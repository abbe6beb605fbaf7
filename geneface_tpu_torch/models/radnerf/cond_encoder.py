"""Condition encoders and the field MLP (port of
``geneface_tpu/models/radnerf/cond_encoder.py``).

- :class:`AudioNet`: strided k=3 Conv1d stack reducing a feature window
  ``[B, W, C_in]`` to ``[B, C_out]``;
- :class:`AudioAttNet`: conv attention over ``seq_len`` per-frame features →
  softmax weights → weighted sum;
- :class:`MLP`: bias-free ReLU stack whose first layer takes a list of input
  parts (parts with a leading dim of 1 broadcast over the samples) and whose
  last layer may be split by output columns.

Compute dtype: like the JAX ``_SplitDense``, inputs and weights are rounded
to ``dtype``, the partial products of every part accumulate in float32, and
the layer output is rounded to ``dtype`` once. The port evaluates the
products as float32 matmuls of the rounded values, which is that arithmetic
exactly (a bf16×bf16 product is exact in float32).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["Conv1dK3", "AudioNet", "AudioAttNet", "MLP"]

_STRIDE_PLANS = {
    1: (1, 1, 1, 1),
    2: (2, 1, 1, 1),
    3: (2, 2, 1, 1),
    4: (2, 2, 1, 1),
    5: (2, 2, 2, 1),
    8: (2, 2, 2, 1),
    16: (2, 2, 2, 2),
}


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.02)


class Conv1dK3(nn.Conv1d):
    """k=3, pad=1 Conv1d on channel-last ``[B, T, C]`` inputs."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__(cin, cout, kernel_size=3, stride=stride, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class AudioNet(nn.Module):
    """``[B, W, C_in]`` feature window → ``[B, dim_aud]``."""

    def __init__(self, dim_in: int, dim_aud: int = 64, win_size: int = 16):
        super().__init__()
        if win_size not in _STRIDE_PLANS:
            raise ValueError(f"unsupported win_size {win_size}")
        chans = (32, 32, 64, 64)
        ins = (dim_in,) + chans[:-1]
        self.convs = nn.ModuleList(
            Conv1dK3(i, o, s) for i, o, s in zip(ins, chans, _STRIDE_PLANS[win_size])
        )
        self.fc1 = nn.Linear(64, 64)
        self.fc2 = nn.Linear(64, dim_aud)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = _lrelu(conv(x))
        x = x.mean(dim=1) if x.shape[1] > 1 else x[:, 0]
        return self.fc2(_lrelu(self.fc1(x)))


class AudioAttNet(nn.Module):
    """``[W, C]`` consecutive per-frame features → attention-smoothed ``[C]``."""

    def __init__(self, in_out_dim: int = 64, seq_len: int = 8):
        super().__init__()
        self.in_out_dim = in_out_dim
        self.seq_len = seq_len
        chans = (16, 8, 4, 2, 1)
        ins = (in_out_dim,) + chans[:-1]
        self.convs = nn.ModuleList(Conv1dK3(i, o) for i, o in zip(ins, chans))
        self.fc = nn.Linear(seq_len, seq_len)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x[:, : self.in_out_dim][None]  # [1, W, C]
        for conv in self.convs:
            y = _lrelu(conv(y))
        y = y.reshape(1, self.seq_len)
        w = torch.softmax(self.fc(y), dim=-1).reshape(self.seq_len, 1)
        return (w * x).sum(dim=0)


def _split_linear(parts: list, weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``concat(parts) @ weight.T`` without the concat: float32 sum of the
    per-part products of ``dtype``-rounded operands."""
    w = weight.to(dtype).float()
    off, y = 0, None
    for p in parts:
        c = p.shape[-1]
        contrib = p.to(dtype).float() @ w[:, off : off + c].T
        y = contrib if y is None else y + contrib
        off += c
    return y


class MLP(nn.Module):
    """Bias-free ReLU MLP of ``num_layers`` linear layers.

    ``split_out`` returns the last layer as a tuple of column slices (each
    rounded through ``dtype`` once, then float32); width-1 slices come back
    as ``[M]`` columns. Otherwise the output is float32 ``[M, dim_out]``.
    """

    def __init__(
        self,
        dim_in: int,
        dim_out: int,
        dim_hidden: int,
        num_layers: int,
        dtype: torch.dtype = torch.float32,
        split_out: tuple | None = None,
    ):
        super().__init__()
        if num_layers < 1:
            raise ValueError("num_layers must be >= 1")
        if split_out is not None and sum(split_out) != dim_out:
            raise ValueError(f"split_out {split_out} does not sum to {dim_out}")
        dims = [dim_in] + [dim_hidden] * (num_layers - 1) + [dim_out]
        self.layers = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1], bias=False) for i in range(num_layers)
        )
        self.dtype = dtype
        self.split_out = split_out

    def forward(self, x):
        parts = list(x) if isinstance(x, (tuple, list)) else [x]
        for layer in self.layers[:-1]:
            parts = [F.relu(_split_linear(parts, layer.weight, self.dtype).to(self.dtype))]
        y = _split_linear(parts, self.layers[-1].weight, self.dtype)
        if self.split_out is None:
            return y.to(self.dtype).float()
        outs, off = [], 0
        for width in self.split_out:
            col = y[..., off : off + width].to(self.dtype).float()
            outs.append(col[..., 0] if width == 1 else col)
            off += width
        return tuple(outs)
