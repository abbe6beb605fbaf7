"""Face parsing: BiSeNet semantic segmentation (port of
``geneface_tpu/datagen/face_parser.py``).

BiSeNet with a ResNet-18 context path, attention-refinement modules and a
feature-fusion module, 19 CelebAMask classes, frozen running-stats
BatchNorm (eps 1e-5). The submodules carry the flax module names, so
:func:`geneface_tpu_torch.convert.load_flax_variables` reads the JAX
package's variables (``params`` and ``batch_stats``) and
:func:`load_parser_npz` the flattened ``.npz`` that
``tools/convert_bisenet_torch.py`` writes.

Modules take and return NHWC tensors, as the flax ones do. The context
path's nearest upsampling is ``jax.image.resize(..., "nearest")``, which
samples at half-pixel centres: torch's ``nearest-exact``, not ``nearest``.
The logits' upsampling is bilinear with ``align_corners=True``, computed
per axis as the JAX package does.

``collapse_to_regions`` maps the 19 classes onto 0 background, 1 head,
2 neck, 3 torso.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
import torch.profiler
from torch import nn

from geneface_tpu_torch.models.layers import FrozenBatchNorm2d

__all__ = [
    "BiSeNet",
    "collapse_to_regions",
    "load_parser_npz",
    "parse_frame",
    "parse_logits",
]

# CelebAMask-HQ classes: 0 bg, 1 skin, 2-3 brows, 4-5 eyes, 6 glasses,
# 7-8 ears, 9 earring, 10 nose, 11 mouth, 12-13 lips, 14 neck,
# 15 necklace, 16 cloth, 17 hair, 18 hat
_HEAD_CLASSES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 17, 18)
_NECK_CLASSES = (14, 15)
_TORSO_CLASSES = (16,)


def collapse_to_regions(labels: np.ndarray) -> np.ndarray:
    """19-class label map → {0 bg, 1 head, 2 neck, 3 torso}."""
    out = np.zeros_like(labels)
    out[np.isin(labels, _HEAD_CLASSES)] = 1
    out[np.isin(labels, _NECK_CLASSES)] = 2
    out[np.isin(labels, _TORSO_CLASSES)] = 3
    return out


def _bn(c: int) -> FrozenBatchNorm2d:
    return FrozenBatchNorm2d(c, eps=1e-5)


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
          bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding, bias=bias)


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, ks: int = 3, stride: int = 1, padding: int = 1):
        super().__init__()
        self.conv = _conv(cin, cout, ks, stride, padding)
        self.bn = _bn(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class _BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, strides: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, strides, 1)
        self.bn1 = _bn(features)
        self.conv2 = _conv(features, features, 3, 1, 1)
        self.bn2 = _bn(features)
        self.down = cin != features or strides != 1
        if self.down:
            self.downsample_conv = _conv(cin, features, 1, strides)
            self.downsample_bn = _bn(features)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        if self.down:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(x + h)


class Resnet18(nn.Module):
    """The context path's backbone → /8, /16 and /32 features."""

    def __init__(self):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = _bn(64)
        self.layer1_0 = _BasicBlock(64, 64)
        self.layer1_1 = _BasicBlock(64, 64)
        self.layer2_0 = _BasicBlock(64, 128, 2)
        self.layer2_1 = _BasicBlock(128, 128)
        self.layer3_0 = _BasicBlock(128, 256, 2)
        self.layer3_1 = _BasicBlock(256, 256)
        self.layer4_0 = _BasicBlock(256, 512, 2)
        self.layer4_1 = _BasicBlock(512, 512)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, 2, 1)
        h = self.layer1_1(self.layer1_0(h))
        f8 = self.layer2_1(self.layer2_0(h))
        f16 = self.layer3_1(self.layer3_0(f8))
        f32 = self.layer4_1(self.layer4_0(f16))
        return f8, f16, f32


class AttentionRefinementModule(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = ConvBNReLU(cin, cout)
        self.conv_atten = _conv(cout, cout, 1)
        self.bn_atten = _bn(cout)

    def forward(self, x):
        feat = self.conv(x)
        att = feat.mean((2, 3), keepdim=True)
        att = torch.sigmoid(self.bn_atten(self.conv_atten(att)))
        return feat * att


def _upsample_nearest(x, hw):
    return F.interpolate(x, size=tuple(hw), mode="nearest-exact")


def _upsample_bilinear_ac(x, hw):
    """Bilinear with ``align_corners=True``, one axis after the other as the
    JAX package computes it."""

    def axis_interp(x, out_len, axis):
        in_len = x.shape[axis]
        if in_len == out_len:
            return x
        if in_len == 1:
            return x.repeat_interleave(out_len, dim=axis)
        pos = torch.arange(out_len, dtype=torch.float32, device=x.device) * (
            (in_len - 1) / (out_len - 1))
        i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, in_len - 2)
        shape = [-1 if a == axis else 1 for a in range(x.ndim)]
        w = (pos - i0.to(torch.float32)).reshape(shape)
        a = x.index_select(axis, i0)
        b = x.index_select(axis, i0 + 1)
        return a * (1.0 - w) + b * w

    return axis_interp(axis_interp(x, hw[0], 2), hw[1], 3)


class ContextPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = Resnet18()
        self.conv_avg = ConvBNReLU(512, 128, ks=1, padding=0)
        self.arm32 = AttentionRefinementModule(512, 128)
        self.conv_head32 = ConvBNReLU(128, 128)
        self.arm16 = AttentionRefinementModule(256, 128)
        self.conv_head16 = ConvBNReLU(128, 128)

    def forward(self, x):
        f8, f16, f32 = self.resnet(x)
        avg = self.conv_avg(f32.mean((2, 3), keepdim=True))
        avg_up = _upsample_nearest(avg, f32.shape[2:])
        f32_up = self.conv_head32(_upsample_nearest(self.arm32(f32) + avg_up, f16.shape[2:]))
        f16_up = self.conv_head16(_upsample_nearest(self.arm16(f16) + f32_up, f8.shape[2:]))
        return f8, f16_up, f32_up


class FeatureFusionModule(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.convblk = ConvBNReLU(cin, cout, ks=1, padding=0)
        self.conv1 = _conv(cout, cout // 4, 1)
        self.conv2 = _conv(cout // 4, cout, 1)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], 1))
        att = feat.mean((2, 3), keepdim=True)
        att = torch.sigmoid(self.conv2(F.relu(self.conv1(att))))
        return feat * att + feat


class BiSeNetOutput(nn.Module):
    def __init__(self, cin: int, mid_chan: int, n_classes: int):
        super().__init__()
        self.conv = ConvBNReLU(cin, mid_chan)
        self.conv_out = _conv(mid_chan, n_classes, 1)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class BiSeNet(nn.Module):
    """[B, H, W, 3] ImageNet-normalized RGB → main logits [B, H, W, n_classes]."""

    def __init__(self, n_classes: int = 19):
        super().__init__()
        self.cp = ContextPath()
        self.ffm = FeatureFusionModule(256, 256)
        self.conv_out = BiSeNetOutput(256, 256, n_classes)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        H, W = x.shape[2:]
        f_res8, f_cp8, _ = self.cp(x)
        out = self.conv_out(self.ffm(f_res8, f_cp8))
        return _upsample_bilinear_ac(out, (H, W)).permute(0, 2, 3, 1)


# ImageNet normalization of the reference's inference entry
_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def load_parser_npz(path: str, device=None) -> BiSeNet:
    """A :class:`BiSeNet` in eval mode on ``device`` (the card by default)
    from a converted ``.npz`` of the flattened flax variables (``params/…``
    and ``batch_stats/…``)."""
    from geneface_tpu_torch import resolve_device
    from geneface_tpu_torch.convert import load_flax_npz

    return load_flax_npz(BiSeNet(), path).to(resolve_device(device)).eval()


@torch.no_grad()
def parse_logits(model: BiSeNet, frames: np.ndarray) -> torch.Tensor:
    """uint8 [B, H, W, 3] RGB → logits [B, H, W, 19] on the model's device."""
    dev = next(model.parameters()).device
    x = (np.asarray(frames, np.float32) / 255.0 - _IMAGENET_MEAN) / _IMAGENET_STD
    with torch.profiler.record_function("gf::parse"):
        return model(torch.as_tensor(x, device=dev))


def parse_frame(model: BiSeNet, frame: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] RGB → 4-region mask [H, W] (the argmax, collapsed)."""
    labels = parse_logits(model, np.asarray(frame)[None])[0].argmax(-1)
    return collapse_to_regions(labels.cpu().numpy())
