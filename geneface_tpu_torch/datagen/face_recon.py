"""Deep3DFaceRecon: single-image 3DMM coefficient regression (port of
``geneface_tpu/datagen/face_recon.py``).

A ResNet-50 with seven 1×1 heads regresses the 257-D BFM coefficients
``[id 80 | exp 64 | tex 80 | angle 3 | gamma 27 | tx ty | tz]`` from a 224²
aligned face crop. The alignment (5-point POS fit against the standard 3-D
landmarks, rescale, 224² crop) runs on the host in numpy; its resize is
:func:`~geneface_tpu_torch.datagen.resize.resize_crop_bicubic_u8`, Pillow's
bicubic bit for bit, without Pillow.

Submodules carry the flax auto names (``Conv_0``, ``BatchNorm_0``,
``_Bottleneck_<i>``, ``head_<i>``), so
:func:`geneface_tpu_torch.convert.load_flax_variables` reads the JAX
package's variables, and :meth:`Reconstructor.from_npz` reads the ``.npz``
of ``tools/convert_deep3drecon.py`` (a pickled variables tree, read through
the port's restricted unpickler).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
import torch.profiler
from torch import nn

from geneface_tpu_torch.models.layers import FrozenBatchNorm2d

__all__ = [
    "extract_5p",
    "POS",
    "align_img",
    "ReconNet",
    "Reconstructor",
    "split_coeff",
]


# ------------------------------------------------------------ alignment ----
def extract_5p(lm: np.ndarray) -> np.ndarray:
    """68 → 5 facial landmarks."""
    lm_idx = np.array([31, 37, 40, 43, 46, 49, 55]) - 1
    lm5p = np.stack(
        [
            lm[lm_idx[0], :],
            np.mean(lm[lm_idx[[1, 2]], :], 0),
            np.mean(lm[lm_idx[[3, 4]], :], 0),
            lm[lm_idx[5], :],
            lm[lm_idx[6], :],
        ],
        axis=0,
    )
    return lm5p[[1, 2, 0, 3, 4], :]


def POS(xp: np.ndarray, x: np.ndarray):
    """Least-squares scaled-orthographic pose from 2-D ↔ 3-D point pairs.
    xp: [2, N] image points, x: [3, N] model points → (t [2, 1], s)."""
    npts = xp.shape[1]
    A = np.zeros([2 * npts, 8])
    A[0: 2 * npts - 1: 2, 0:3] = x.transpose()
    A[0: 2 * npts - 1: 2, 3] = 1
    A[1: 2 * npts: 2, 4:7] = x.transpose()
    A[1: 2 * npts: 2, 7] = 1
    b = np.reshape(xp.transpose(), [2 * npts, 1])
    k, _, _, _ = np.linalg.lstsq(A, b, rcond=None)
    R1, R2 = k[0:3], k[4:7]
    s = (np.linalg.norm(R1) + np.linalg.norm(R2)) / 2
    t = np.stack([k[3], k[7]], axis=0)
    return t, s


def _resize_n_crop_img(img_u8, lm, t, s, target_size=224.0):
    """Rescale by ``s`` (Pillow bicubic) and crop ``target_size``² around
    the translated centre."""
    from geneface_tpu_torch.datagen.resize import resize_crop_bicubic_u8

    h0, w0 = img_u8.shape[:2]
    w = (w0 * s).astype(np.int32)
    h = (h0 * s).astype(np.int32)
    left = (w / 2 - target_size / 2 + float((t[0] - w0 / 2) * s)).astype(np.int32)
    right = left + int(target_size)
    up = (h / 2 - target_size / 2 + float((h0 / 2 - t[1]) * s)).astype(np.int32)
    below = up + int(target_size)
    img = resize_crop_bicubic_u8(img_u8, (int(w), int(h)),
                                 (int(left), int(up), int(right), int(below)))
    lm = np.stack([lm[:, 0] - t[0] + w0 / 2, lm[:, 1] - t[1] + h0 / 2], axis=1) * s
    lm = lm - np.reshape(
        np.array([(w / 2 - target_size / 2), (h / 2 - target_size / 2)]), [1, 2]
    )
    return img, lm


def align_img(
    img_u8: np.ndarray,  # [H, W, 3] uint8
    lm: np.ndarray,  # [68, 2] or [5, 2]; y up (image-flipped)
    lm3d_std: np.ndarray,  # [5, 3] standard 3-D landmarks
    target_size: float = 224.0,
    rescale_factor: float = 102.0,
):
    """POS fit → rescale → centre crop. Returns (trans_params [5], aligned
    image [224, 224, 3] uint8, landmarks in the crop)."""
    h0, w0 = img_u8.shape[:2]
    lm5p = extract_5p(lm) if lm.shape[0] != 5 else lm
    t, s = POS(lm5p.transpose(), lm3d_std.transpose())
    s = rescale_factor / s
    img_new, lm_new = _resize_n_crop_img(img_u8, lm, t, s, target_size)
    trans_params = np.array([w0, h0, s, float(t[0]), float(t[1])])
    return trans_params, img_new, lm_new


# -------------------------------------------------------------- network ----
def _bn(c: int) -> FrozenBatchNorm2d:
    return FrozenBatchNorm2d(c, eps=1e-5)  # flax's default epsilon


class _Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, planes, 1, bias=False)
        self.BatchNorm_0 = _bn(planes)
        self.Conv_1 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.BatchNorm_1 = _bn(planes)
        self.Conv_2 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.BatchNorm_2 = _bn(planes * 4)
        self.downsample = downsample
        if downsample:
            self.Conv_3 = nn.Conv2d(cin, planes * 4, 1, stride, bias=False)
            self.BatchNorm_3 = _bn(planes * 4)

    def forward(self, x):
        out = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        out = F.relu(self.BatchNorm_1(self.Conv_1(out)))
        out = self.BatchNorm_2(self.Conv_2(out))
        identity = self.BatchNorm_3(self.Conv_3(x)) if self.downsample else x
        return F.relu(out + identity)


class ReconNet(nn.Module):
    """ResNet-50 + 7 coefficient heads: [B, 224, 224, 3] RGB in [0, 1]
    (NHWC) → [B, 257] BFM coefficients."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 head_dims: Sequence[int] = (80, 64, 80, 3, 27, 2, 1)):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.BatchNorm_0 = _bn(64)
        planes, cin, i = 64, 64, 0
        for stage, n_blocks in enumerate(layers):
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                setattr(self, f"_Bottleneck_{i}", _Bottleneck(cin, planes, stride, b == 0))
                cin, i = planes * 4, i + 1
            planes *= 2
        self.n_blocks = i
        self.head_dims = tuple(head_dims)
        for j, d in enumerate(head_dims):
            setattr(self, f"head_{j}", nn.Conv2d(cin, d, 1, bias=True))

    def forward(self, x):
        x = F.relu(self.BatchNorm_0(self.Conv_0(x.permute(0, 3, 1, 2))))
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(self.n_blocks):
            x = getattr(self, f"_Bottleneck_{i}")(x)
        x = x.mean((2, 3), keepdim=True)
        outs = [getattr(self, f"head_{j}")(x) for j in range(len(self.head_dims))]
        return torch.cat(outs, 1).reshape(x.shape[0], -1)


def split_coeff(coeffs) -> dict:
    """257-D coefficients → named groups."""
    return {
        "id": coeffs[..., 0:80],
        "exp": coeffs[..., 80:144],
        "tex": coeffs[..., 144:224],
        "angle": coeffs[..., 224:227],
        "gamma": coeffs[..., 227:254],
        "trans": coeffs[..., 254:257],
    }


# ---------------------------------------------------------- reconstructor --
# the standard 5-point 3-D landmarks of the BFM front face (nose-centred,
# y up), the JAX package's default
_DEFAULT_LM3D_STD = np.array(
    [
        [-0.31148657, 0.29036078, 0.13377953],
        [0.30979887, 0.28972036, 0.13179526],
        [0.0032535, -0.04617932, 0.55244243],
        [-0.25216928, -0.38133916, 0.22405732],
        [0.2484662, -0.38128927, 0.22235769],
    ],
    np.float32,
)


class Reconstructor:
    """``recon_coeff(batched_images, batched_lm, return_image=True)`` →
    ``(coeff [B, 257], aligned_images [B, 224, 224, 3] uint8)``. Landmarks
    are 68- or 5-point in image coordinates (y down); they are flipped to
    y up inside, as the reference does.

    ``net`` is a :class:`ReconNet` with its weights (moved to ``device``,
    the card by default); without one, a :class:`ReconNet` at torch's
    default initialization (the JAX package's default is flax's, which
    differs)."""

    def __init__(
        self,
        net: ReconNet | None = None,
        lm3d_std: np.ndarray | None = None,
        rescale_factor: float = 102.0,
        device=None,
    ):
        from geneface_tpu_torch import resolve_device

        self.device = resolve_device(device)
        self.net = (net if net is not None else ReconNet()).to(self.device).eval()
        self.lm3d_std = (
            np.asarray(lm3d_std, np.float32) if lm3d_std is not None else _DEFAULT_LM3D_STD
        )
        self.rescale_factor = rescale_factor

    @classmethod
    def from_npz(cls, path: str, **kwargs) -> "Reconstructor":
        """Converted weights: a ``.npz`` whose ``params`` entry holds the
        pickled flax variables (read by the restricted unpickler)."""
        import io

        from geneface_tpu_torch.convert import load_flax_variables
        from geneface_tpu_torch.utils.checkpoint import _CheckpointUnpickler

        with np.load(path, allow_pickle=False) as z:
            blob = z["params"].tobytes()
        variables = _CheckpointUnpickler(io.BytesIO(blob)).load()
        return cls(net=load_flax_variables(ReconNet(), variables), **kwargs)

    def preprocess(self, img_u8: np.ndarray, lm: np.ndarray) -> np.ndarray:
        H = img_u8.shape[0]
        lm = np.asarray(lm, np.float64).reshape(-1, 2).copy()
        lm[:, -1] = H - 1 - lm[:, -1]
        _, aligned, _ = align_img(np.asarray(img_u8, np.uint8), lm, self.lm3d_std,
                                  rescale_factor=self.rescale_factor)
        return aligned

    @torch.no_grad()
    def coeffs(self, aligned: np.ndarray) -> np.ndarray:
        """uint8 [B, 224, 224, 3] aligned crops → [B, 257] float32."""
        x = torch.as_tensor(np.asarray(aligned, np.float32) / 255.0, device=self.device)
        with torch.profiler.record_function("gf::recon"):
            return self.net(x).cpu().numpy()

    def recon_coeff(
        self,
        batched_images: np.ndarray,  # [B, H, W, 3] uint8
        batched_lm: np.ndarray,  # [B, 68|5, 2]
        return_image: bool = True,
        batch_mode: bool = True,  # signature parity; batched either way
    ):
        aligned = np.stack([self.preprocess(batched_images[i], batched_lm[i])
                            for i in range(batched_images.shape[0])])
        coeff = self.coeffs(aligned)
        return (coeff, aligned) if return_image else (coeff, None)

    __call__ = recon_coeff
