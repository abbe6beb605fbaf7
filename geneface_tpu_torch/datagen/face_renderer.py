"""Differentiable 3DMM face renderer for photometric head-pose tracking
(port of ``geneface_tpu/datagen/face_renderer.py``).

A soft vertex splat: every vertex adds its shaded colour into its four
bilinear-neighbour pixels of the downsampled target, weighted by a soft
depth test ``exp(-(z - z_ref) / z_tau)``; dividing by the accumulated
weight makes that a softmax over depth per pixel. Shading is per-vertex
normals (area-weighted triangle normals summed to vertices) under 9-band
spherical-harmonics light with the reference's +0.8 ambient bias.

Both sums run on the row scatter-add K1 (``csrc/scatter_add_rows.cu``)
through :func:`geneface_tpu_torch.ops.scatter.scatter_add_rows`, so their
backward is the row gather K8:

- the normals: the ``3F`` triangle-corner normals of all ``B`` frames into
  ``B·V`` rows (row ``b·V + tris``), 3 columns wide; site
  ``("datagen", "normals")``;
- the splat: the four corners of every vertex of all frames into ``B·h·w``
  rows of ``(r·z, g·z, b·z, z)`` weights in one launch; a corner outside the
  frame goes to row ``B·h·w``, which the scatter drops, as the JAX
  package's ``mode="drop"`` does; site ``("datagen", "splat")``.

A CPU tensor runs the plain versions of both kernels.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from geneface_tpu_torch.ops.scatter import scatter_add_rows

__all__ = [
    "FullFaceBasis",
    "full_basis_from_bfm",
    "vertex_normals",
    "sh9_irradiance",
    "render_vertices_soft",
    "photometric_loss",
    "downsample_frames",
]


class FullFaceBasis(NamedTuple):
    """Vertex-level 3DMM: geometry, per-vertex albedo and topology.

    geo = mean + id_base @ id + exp_base @ exp, reshaped [V, 3];
    albedo = tex_mean + tex_base @ tex, reshaped [V, 3] in [0, 1].
    ``lm_index`` maps the 68 landmarks to vertex ids. ``tris`` may be empty
    ([0, 3]): the normals are then +z (albedo-only shading)."""

    mean: torch.Tensor  # [V*3]
    id_base: torch.Tensor  # [V*3, id_dim]
    exp_base: torch.Tensor  # [V*3, exp_dim]
    tex_mean: torch.Tensor  # [V*3]
    tex_base: torch.Tensor  # [V*3, tex_dim]
    tris: torch.Tensor  # [F, 3] int64
    lm_index: torch.Tensor  # [68] int64

    def to(self, device) -> "FullFaceBasis":
        return FullFaceBasis(*(t.to(device) for t in self))


def full_basis_from_bfm(mat_path: str, device="cpu") -> FullFaceBasis:
    """A vertex-level basis from BFM09's ``BFM_model_front.mat`` (not in the
    repository); albedo normalized to [0, 1]."""
    from scipy.io import loadmat

    m = loadmat(mat_path)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return FullFaceBasis(
        mean=f32(m["meanshape"].reshape(-1)),
        id_base=f32(m["idBase"]),
        exp_base=f32(m["exBase"]),
        tex_mean=f32(m["meantex"].reshape(-1) / 255.0),
        tex_base=f32(m["texBase"] / 255.0),
        tris=torch.as_tensor(np.asarray(m["tri"], np.int64) - 1, device=device),
        lm_index=torch.as_tensor(m["keypoints"].reshape(-1).astype(np.int64) - 1, device=device),
    )


def _unit(x: torch.Tensor) -> torch.Tensor:
    # rsqrt(|x|^2 + eps): a finite gradient at x = 0 (degenerate triangles,
    # cancelling vertex normals)
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)


def vertex_normals(geo: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """[B, V, 3] vertices + [F, 3] triangles → unit vertex normals [B, V, 3]
    (area-weighted triangle normals summed to their corners on K1)."""
    if tris.shape[0] == 0:
        z = torch.zeros_like(geo[..., :2])
        return torch.cat([z, torch.ones_like(geo[..., 2:])], -1)
    B, V, _ = geo.shape
    v1, v2, v3 = geo[:, tris[:, 0]], geo[:, tris[:, 1]], geo[:, tris[:, 2]]
    fn = _unit(torch.linalg.cross(v2 - v1, v3 - v1))  # [B, F, 3]
    fn3 = fn.repeat_interleave(3, dim=1)  # [B, 3F, 3]: the triangle's normal per corner
    base = torch.arange(B, device=geo.device)[:, None] * V
    rows = (base + tris.reshape(1, -1)).reshape(-1).to(torch.int32)
    vn = scatter_add_rows(rows, fn3.reshape(-1, 3), B * V, site=("datagen", "normals"))
    return _unit(vn.reshape(B, V, 3))


# the real-SH irradiance constants (Ramamoorthi & Hanrahan)
_A = (math.pi, 2.0 * math.pi / math.sqrt(3.0), 2.0 * math.pi / math.sqrt(8.0))
_C = (
    1.0 / math.sqrt(4.0 * math.pi),
    math.sqrt(3.0) / math.sqrt(4.0 * math.pi),
    3.0 * math.sqrt(5.0) / math.sqrt(12.0 * math.pi),
)
_D0 = 0.5 / math.sqrt(3.0)


def sh9_irradiance(normals: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """[B, V, 3] unit normals + [B, 27] SH coefficients (3 channels × 9
    bands, +0.8 on the DC band) → [B, V, 3] RGB irradiance."""
    B = normals.shape[0]
    bias = torch.zeros(9, dtype=gamma.dtype, device=gamma.device)
    bias[0] = 0.8
    g = gamma.reshape(B, 3, 9) + bias
    nx, ny, nz = normals[..., 0], normals[..., 1], normals[..., 2]
    Y = torch.stack(
        [
            torch.full_like(nx, _A[0] * _C[0]),
            -_A[1] * _C[1] * ny,
            _A[1] * _C[1] * nz,
            -_A[1] * _C[1] * nx,
            _A[2] * _C[2] * nx * ny,
            -_A[2] * _C[2] * ny * nz,
            _A[2] * _C[2] * _D0 * (3.0 * nz**2 - 1.0),
            -_A[2] * _C[2] * nx * nz,
            _A[2] * _C[2] * 0.5 * (nx**2 - ny**2),
        ],
        dim=-1,
    )  # [B, V, 9]
    return torch.einsum("bvk,bck->bvc", Y, g)


def render_vertices_soft(
    cam_geo: torch.Tensor,  # [B, V, 3] camera-space vertices (+z forward)
    colors: torch.Tensor,  # [B, V, 3] shaded vertex colours
    focal,
    cxy,  # [2] principal point (full-resolution pixels)
    H: int,
    W: int,
    *,
    scale: int = 4,  # render at (H / scale, W / scale)
    z_tau: float = 0.05,  # soft depth-test temperature (camera units)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Soft vertex-splat render → (rgb [B, h, w, 3], weight [B, h, w]).
    Pixels with about zero weight are background (mask ``weight > thresh``)."""
    B, V, _ = cam_geo.shape
    h, w = H // scale, W // scale
    x, y, z = cam_geo[..., 0], cam_geo[..., 1], cam_geo[..., 2]
    zc = torch.maximum(z, z.new_tensor(1e-5))
    u = (focal * x / zc + cxy[0]) / scale  # [B, V] column
    v = (focal * y / zc + cxy[1]) / scale  # row
    z_ref = zc.min(dim=1, keepdim=True).values.detach()
    zw = torch.exp(-(zc - z_ref) / z_tau)  # [B, V]

    u0 = torch.floor(u - 0.5)
    v0 = torch.floor(v - 0.5)
    fu = u - 0.5 - u0
    fv = v - 0.5 - v0
    # clamped before the cast: a vertex at z <= 1e-5 projects ~1e8 pixels
    # away, where a float -> int32 cast is not defined; a clamped corner is
    # still outside the frame
    iu0 = u0.detach().clamp(-2, w).to(torch.int64)
    iv0 = v0.detach().clamp(-2, h).to(torch.int64)

    rgbw = torch.cat([colors * zw[..., None], zw[..., None]], dim=-1)  # [B, V, 4]
    frame = torch.arange(B, device=cam_geo.device)[:, None] * (h * w)
    rows, upd = [], []
    for du, dv, wgt in (
        (0, 0, (1 - fu) * (1 - fv)),
        (1, 0, fu * (1 - fv)),
        (0, 1, (1 - fu) * fv),
        (1, 1, fu * fv),
    ):
        cu, cv = iu0 + du, iv0 + dv
        ok = (cu >= 0) & (cu < w) & (cv >= 0) & (cv < h)
        rows.append(torch.where(ok, frame + cv * w + cu, B * h * w))  # dropped
        upd.append(wgt[..., None] * rgbw)
    num = scatter_add_rows(
        torch.cat(rows).reshape(-1).to(torch.int32),
        torch.cat(upd).reshape(-1, 4),
        B * h * w,
        site=("datagen", "splat"),
    )
    weight = num[:, 3]
    rgb = num[:, :3] / torch.maximum(weight, weight.new_tensor(1e-8))[:, None]
    return rgb.reshape(B, h, w, 3), weight.reshape(B, h, w)


def photometric_loss(
    rgb: torch.Tensor,  # [B, h, w, 3] rendered
    weight: torch.Tensor,  # [B, h, w] splat coverage
    target: torch.Tensor,  # [B, h, w, 3] downsampled frames
    mask_thresh: float = 0.05,
) -> torch.Tensor:
    """Masked L2 colour loss over the pixels the render covers."""
    mask = (weight > mask_thresh).detach().to(rgb.dtype)
    diff = ((rgb - target) ** 2).sum(-1) * mask
    return diff.sum() / torch.maximum(mask.sum(), mask.new_tensor(1.0))


def downsample_frames(frames: np.ndarray, scale: int) -> np.ndarray:
    """[B, H, W, 3] → [B, H/scale, W/scale, 3] box average (host numpy)."""
    B, H, W, C = frames.shape
    h, w = H // scale, W // scale
    return (
        frames[:, : h * scale, : w * scale]
        .reshape(B, h, scale, w, scale, C)
        .mean(axis=(2, 4))
    )
