"""LPIPS perceptual distance over the AlexNet tower (port of
``geneface_tpu/models/lpips.py``), the criterion of the lip fine-tune phase:

    d(x, y) = Σ_l mean_hw Σ_c relu(w_l)_c · (φ_l(x)/|φ_l(x)| − φ_l(y)/|φ_l(y)|)_c²

with ``φ_l`` the five ReLU feature maps of the AlexNet stack (stride-4
11×11 conv, then a 3×3/2 max-pool before stages 1 and 2, as flax's
``nn.max_pool`` with ``VALID`` padding) and ``|·|`` the norm over channels
plus 1e-10. The modules compute in NCHW (``torch.nn.Conv2d``, cuDNN on
the card); :meth:`LPIPS.forward` takes NHWC images, as the JAX
module does. The network is frozen: its parameters take no gradient, the
inputs do.

Weights: :func:`lpips_params_from_npz` reads the ``.npz`` that
``tools/convert_lpips_torch.py`` writes (``conv{i}/kernel`` HWIO,
``conv{i}/bias``, ``lin{i}``) into the flax tree
``{"params": {"alex": {"conv{i}": {kernel, bias}}, "lin{i}": ...}}`` that
:func:`geneface_tpu_torch.convert.lpips_state_dict` maps onto this module.
:meth:`LPIPS.reset_parameters` draws flax's initializers' distributions
(LeCun-normal kernels, zero biases, uniform [0, 1) heads) from a generator.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["LPIPS", "lpips_params_from_npz", "ALEX_CFG"]

#: the ScalingLayer's shift and scale of the [-1, 1] input
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
#: AlexNet stages: (out channels, kernel, stride, padding)
ALEX_CFG = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1))
_POOL_BEFORE = (1, 2)


class _AlexFeatures(nn.Module):
    """The AlexNet conv tower → its five ReLU feature maps (NCHW)."""

    def __init__(self):
        super().__init__()
        cin = 3
        for i, (ch, k, s, p) in enumerate(ALEX_CFG):
            setattr(self, f"conv{i}", nn.Conv2d(cin, ch, k, stride=s, padding=p))
            cin = ch

    def forward(self, x: torch.Tensor) -> list:
        feats = []
        for i in range(len(ALEX_CFG)):
            if i in _POOL_BEFORE:
                x = F.max_pool2d(x, 3, 2)
            x = F.relu(getattr(self, f"conv{i}")(x))
            feats.append(x)
        return feats


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """Perceptual distance of NHWC image batches → ``[N]``.
    ``input_range``: ``"unit"`` (images in [0, 1], mapped to [-1, 1]) or
    ``"pm1"`` (already in [-1, 1])."""

    def __init__(self, input_range: str = "unit"):
        super().__init__()
        if input_range not in ("unit", "pm1"):
            raise ValueError(f"input_range {input_range!r}: 'unit' or 'pm1'")
        self.input_range = input_range
        self.alex = _AlexFeatures()
        for i, (ch, _, _, _) in enumerate(ALEX_CFG):
            setattr(self, f"lin{i}", nn.Parameter(torch.zeros(ch)))
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1), persistent=False)
        self.requires_grad_(False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "LPIPS":
        """LeCun-normal kernels (truncated at 2σ, flax's ``lecun_normal``),
        zero biases and uniform [0, 1) heads, drawn on the CPU."""
        for i in range(len(ALEX_CFG)):
            conv = getattr(self.alex, f"conv{i}")
            fan_in = conv.weight[0].numel()
            # flax's truncated normal: std corrected for the truncation at 2σ
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            w = torch.empty(conv.weight.shape)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            conv.weight.copy_(w * std)
            conv.bias.zero_()
            lin = getattr(self, f"lin{i}")
            lin.copy_(torch.rand(lin.shape, generator=generator))
        return self

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if x.shape[1] < 32 or x.shape[2] < 32:
            raise ValueError(
                f"LPIPS needs inputs >= 32x32 (got {x.shape[1]}x{x.shape[2]}): "
                "the AlexNet stack pools smaller maps to zero size"
            )
        x = x.permute(0, 3, 1, 2)
        y = y.permute(0, 3, 1, 2)
        if self.input_range == "unit":
            x = 2.0 * x - 1.0
            y = 2.0 * y - 1.0
        x = (x - self.shift) / self.scale
        y = (y - self.shift) / self.scale
        total = 0.0
        for i, (a, b) in enumerate(zip(self.alex(x), self.alex(y))):
            diff = _unit_normalize(a) - _unit_normalize(b)
            w = F.relu(getattr(self, f"lin{i}")).reshape(1, -1, 1, 1)
            total = total + torch.mean(torch.sum(diff * diff * w, dim=1), dim=(1, 2))
        return total


def lpips_params_from_npz(path: str) -> dict:
    """A converted ``.npz`` (``conv{i}/kernel`` HWIO, ``conv{i}/bias``,
    ``lin{i}``) → the flax parameter tree ``{"params": ...}`` of numpy
    arrays."""
    data = np.load(path)
    n = len(ALEX_CFG)
    params = {"alex": {f"conv{i}": {"kernel": np.asarray(data[f"conv{i}/kernel"]),
                                    "bias": np.asarray(data[f"conv{i}/bias"])}
                       for i in range(n)}}
    for i in range(n):
        params[f"lin{i}"] = np.asarray(data[f"lin{i}"])
    return {"params": params}
