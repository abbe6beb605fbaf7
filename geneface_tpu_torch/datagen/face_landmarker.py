"""2-D facial landmarks: FAN (2DFAN-4) (port of
``geneface_tpu/datagen/face_landmarker.py``).

Four stacked depth-4 hourglasses produce 68 heatmaps at 64² from a 256²
face crop; :func:`decode_heatmaps` turns them into pixel landmarks with the
quarter-pixel shift toward the larger neighbour. The crop is a square
around the parser's head mask (:func:`head_crop_from_mask`). BatchNorm is
frozen running statistics (eps 1e-5). Submodules carry the flax module
names (``Conv_0``, ``BatchNorm_0``, … in creation order, the explicitly
named ones as named), so :func:`geneface_tpu_torch.convert.load_flax_variables`
reads the JAX package's variables and :meth:`FANLandmarker.from_npz` the
``.npz`` of ``tools/convert_fan_torch.py``.

The crop's resize to 256² is :func:`~geneface_tpu_torch.datagen.resize.resize_bilinear_u8`,
OpenCV's ``INTER_LINEAR`` on uint8 bit for bit, without OpenCV.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
import torch.profiler
from torch import nn

from geneface_tpu_torch.models.layers import FrozenBatchNorm2d

__all__ = [
    "FAN",
    "decode_heatmaps",
    "head_crop_from_mask",
    "FANLandmarker",
]


def _bn(c: int) -> FrozenBatchNorm2d:
    return FrozenBatchNorm2d(c, eps=1e-5)


def _conv(cin: int, cout: int, k: int, padding: int = 0, bias: bool = True,
          stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding, bias=bias)


class ConvBlock(nn.Module):
    """bn-relu-conv ×3 with the channel split 1/2 + 1/4 + 1/4, concatenated,
    plus the (projected) input."""

    def __init__(self, cin: int, out_planes: int):
        super().__init__()
        c = out_planes
        self.BatchNorm_0 = _bn(cin)
        self.Conv_0 = _conv(cin, c // 2, 3, 1, bias=False)
        self.BatchNorm_1 = _bn(c // 2)
        self.Conv_1 = _conv(c // 2, c // 4, 3, 1, bias=False)
        self.BatchNorm_2 = _bn(c // 4)
        self.Conv_2 = _conv(c // 4, c // 4, 3, 1, bias=False)
        self.down = cin != c
        if self.down:
            self.BatchNorm_3 = _bn(cin)
            self.downsample_conv = _conv(cin, c, 1, bias=False)

    def forward(self, x):
        o1 = self.Conv_0(F.relu(self.BatchNorm_0(x)))
        o2 = self.Conv_1(F.relu(self.BatchNorm_1(o1)))
        o3 = self.Conv_2(F.relu(self.BatchNorm_2(o2)))
        out = torch.cat([o1, o2, o3], 1)
        if self.down:
            x = self.downsample_conv(F.relu(self.BatchNorm_3(x)))
        return out + x


class HourGlass(nn.Module):
    """Depth-``depth`` recursive hourglass of 256 features."""

    def __init__(self, depth: int = 4):
        super().__init__()
        self.depth = depth
        for lv in range(depth, 0, -1):
            setattr(self, f"b1_{lv}", ConvBlock(256, 256))
            setattr(self, f"b2_{lv}", ConvBlock(256, 256))
            setattr(self, f"b3_{lv}", ConvBlock(256, 256))
        self.b2_plus_1 = ConvBlock(256, 256)

    def _level(self, lv: int, inp):
        up1 = getattr(self, f"b1_{lv}")(inp)
        low = getattr(self, f"b2_{lv}")(F.avg_pool2d(inp, 2, 2))
        low2 = self._level(lv - 1, low) if lv > 1 else self.b2_plus_1(low)
        low3 = getattr(self, f"b3_{lv}")(low2)
        return up1 + F.interpolate(low3, size=up1.shape[2:], mode="nearest-exact")

    def forward(self, x):
        return self._level(self.depth, x)


class FAN(nn.Module):
    """[B, 256, 256, 3] RGB in [0, 1] → [B, 64, 64, 68] heatmaps of the last
    hourglass module (NHWC in and out, as the flax module)."""

    def __init__(self, num_modules: int = 4):
        super().__init__()
        self.num_modules = num_modules
        self.conv1 = _conv(3, 64, 7, 3, stride=2)
        self.BatchNorm_0 = _bn(64)
        self.conv2 = ConvBlock(64, 128)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, 256)
        for i in range(num_modules):
            setattr(self, f"m{i}", HourGlass())
            setattr(self, f"top_m_{i}", ConvBlock(256, 256))
            setattr(self, f"conv_last{i}", _conv(256, 256, 1))
            setattr(self, f"BatchNorm_{i + 1}", _bn(256))
            setattr(self, f"l{i}", _conv(256, 68, 1))
            if i < num_modules - 1:
                setattr(self, f"bl{i}", _conv(256, 256, 1))
                setattr(self, f"al{i}", _conv(68, 256, 1))

    def forward(self, x):
        x = F.relu(self.BatchNorm_0(self.conv1(x.permute(0, 3, 1, 2))))
        x = F.avg_pool2d(self.conv2(x), 2, 2)
        previous = self.conv4(self.conv3(x))
        out = None
        for i in range(self.num_modules):
            ll = getattr(self, f"top_m_{i}")(getattr(self, f"m{i}")(previous))
            ll = F.relu(getattr(self, f"BatchNorm_{i + 1}")(getattr(self, f"conv_last{i}")(ll)))
            out = getattr(self, f"l{i}")(ll)
            if i < self.num_modules - 1:
                previous = previous + getattr(self, f"bl{i}")(ll) + getattr(self, f"al{i}")(out)
        return out.permute(0, 2, 3, 1)


def decode_heatmaps(hm: np.ndarray) -> np.ndarray:
    """[68, Hh, Wh] heatmaps → [68, 2] (x, y) in heatmap pixels, with the
    quarter-pixel shift toward the larger neighbour."""
    hm = np.asarray(hm)
    L, Hh, Wh = hm.shape
    idx = hm.reshape(L, -1).argmax(axis=-1)
    ys, xs = np.divmod(idx, Wh)
    pts = np.stack([xs, ys], -1).astype(np.float32)
    for i in range(L):
        x, y = int(xs[i]), int(ys[i])
        if 0 < x < Wh - 1:
            pts[i, 0] += 0.25 * np.sign(hm[i, y, x + 1] - hm[i, y, x - 1])
        if 0 < y < Hh - 1:
            pts[i, 1] += 0.25 * np.sign(hm[i, y + 1, x] - hm[i, y - 1, x])
    return pts + 0.5


def head_crop_from_mask(mask: np.ndarray, pad: float = 0.35) -> tuple:
    """Square crop box (x0, y0, side) around the head mask's (class 1) box."""
    ys, xs = np.nonzero(mask == 1)
    H, W = mask.shape
    if len(ys) == 0:
        side = min(H, W)
        return (W - side) // 2, (H - side) // 2, side
    cy, cx = (ys.min() + ys.max()) / 2, (xs.min() + xs.max()) / 2
    side = max(ys.max() - ys.min(), xs.max() - xs.min()) * (1.0 + pad)
    side = int(min(max(side, 32), min(H, W)))
    x0 = int(np.clip(cx - side / 2, 0, W - side))
    y0 = int(np.clip(cy - side / 2, 0, H - side))
    return x0, y0, side


class FANLandmarker:
    """``lm_fn``-compatible callable: frame (+ the parser's mask) → [68, 2]
    pixel landmarks. ``model`` is a :class:`FAN` (moved to ``device``, the
    card by default, and put in eval mode)."""

    def __init__(self, model: FAN, device=None):
        from geneface_tpu_torch import resolve_device

        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()

    @classmethod
    def from_npz(cls, path: str, device=None) -> "FANLandmarker":
        """From a converted ``.npz`` of the flattened flax variables."""
        from geneface_tpu_torch.convert import load_flax_npz

        return cls(load_flax_npz(FAN(), path), device)

    def crop(self, frame: np.ndarray, mask: np.ndarray | None = None) -> tuple:
        """(256² uint8 crop, x0, y0, side)."""
        frame = np.asarray(frame)
        H, W = frame.shape[:2]
        if mask is not None:
            x0, y0, side = head_crop_from_mask(np.asarray(mask))
        else:
            side = min(H, W)
            x0, y0 = (W - side) // 2, (H - side) // 2
        from geneface_tpu_torch.datagen.resize import resize_bilinear_u8

        crop = resize_bilinear_u8(frame[y0: y0 + side, x0: x0 + side], (256, 256))
        return crop, x0, y0, side

    @torch.no_grad()
    def heatmaps(self, crops: np.ndarray) -> torch.Tensor:
        """uint8 [B, 256, 256, 3] crops → [B, 64, 64, 68] heatmaps."""
        x = torch.as_tensor(np.asarray(crops, np.float32) / 255.0, device=self.device)
        with torch.profiler.record_function("gf::fan"):
            return self.model(x)

    def __call__(self, frame: np.ndarray, mask: np.ndarray | None = None) -> np.ndarray:
        crop, x0, y0, side = self.crop(frame, mask)
        hm = self.heatmaps(crop[None])[0].cpu().numpy()
        pts = decode_heatmaps(hm.transpose(2, 0, 1))  # [68, 2] in 64-space
        return pts * (side / 64.0) + np.asarray([x0, y0], np.float32)
