"""Camera math (copies of ``geneface_tpu/utils/camera.py``): ngp pose
conversion, 6-D pose vectors and their inverse (euler + translation → c2w,
which datagen writes; c2w → euler + translation, the vanilla torso's pose
condition), background coordinates and pinhole rays on the host
(numpy), and the ray / background-coordinate rebuild of a training batch
from its pixel indices on the device (torch)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "nerf_matrix_to_ngp",
    "convert_poses",
    "euler_to_matrix",
    "euler_trans_to_c2w",
    "c2w_to_euler_trans",
    "get_bg_coords",
    "get_rays",
    "get_rays_device",
    "bg_coords_device",
]


def nerf_matrix_to_ngp(pose: np.ndarray, scale: float = 4.0, offset=(0, 0, 0)) -> np.ndarray:
    """OpenGL-style nerf pose → instant-ngp convention: rows permuted
    (y,z,x), columns 1..2 negated, translation scaled+offset."""
    p = np.asarray(pose, np.float32)
    return np.array(
        [
            [p[1, 0], -p[1, 1], -p[1, 2], p[1, 3] * scale + offset[0]],
            [p[2, 0], -p[2, 1], -p[2, 2], p[2, 3] * scale + offset[1]],
            [p[0, 0], -p[0, 1], -p[0, 2], p[0, 3] * scale + offset[2]],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )


def _matrix_to_euler(matrix: np.ndarray) -> np.ndarray:
    """Rotation matrices [..., 3, 3] → intrinsic-XYZ euler [..., 3]."""
    m = np.asarray(matrix, np.float32)
    b = np.arcsin(np.clip(m[..., 0, 2], -1.0, 1.0))
    a = np.arctan2(-m[..., 1, 2], m[..., 2, 2])
    c = np.arctan2(-m[..., 0, 1], m[..., 0, 0])
    return np.stack([a, b, c], axis=-1)


def convert_poses(poses: np.ndarray) -> np.ndarray:
    """[B, 4, 4] c2w → [B, 6] (3 euler-XYZ, 3 translation)."""
    p = np.asarray(poses, np.float32)
    return np.concatenate([_matrix_to_euler(p[:, :3, :3]), p[:, :3, 3]], axis=-1)


def euler_to_matrix(euler: np.ndarray) -> np.ndarray:
    """Intrinsic-XYZ euler [..., 3] → rotation matrices [..., 3, 3]
    (``R = Rx(a) @ Ry(b) @ Rz(c)``)."""
    e = np.asarray(euler, np.float32)
    a, b, c = e[..., 0], e[..., 1], e[..., 2]
    ca, sa = np.cos(a), np.sin(a)
    cb, sb = np.cos(b), np.sin(b)
    cc, sc = np.cos(c), np.sin(c)
    m = np.empty(e.shape[:-1] + (3, 3), np.float32)
    m[..., 0, 0] = cb * cc
    m[..., 0, 1] = -cb * sc
    m[..., 0, 2] = sb
    m[..., 1, 0] = sa * sb * cc + ca * sc
    m[..., 1, 1] = -sa * sb * sc + ca * cc
    m[..., 1, 2] = -sa * cb
    m[..., 2, 0] = -ca * sb * cc + sa * sc
    m[..., 2, 1] = ca * sb * sc + sa * cc
    m[..., 2, 2] = ca * cb
    return m


def euler_trans_to_c2w(euler: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """Inverse of :func:`convert_poses`: euler [B, 3] + trans [B, 3] → [B, 4, 4]."""
    B = euler.shape[0]
    out = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    out[:, :3, :3] = euler_to_matrix(euler)
    out[:, :3, 3] = trans
    return out


def c2w_to_euler_trans(c2w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[B, 4, 4] → (intrinsic-XYZ euler [B, 3], translation [B, 3])."""
    c2w = np.asarray(c2w, np.float32)
    return _matrix_to_euler(c2w[:, :3, :3]), c2w[:, :3, 3]


def get_bg_coords(H: int, W: int) -> np.ndarray:
    """[1, H*W, 2] normalized pixel coords in [-1, 1] (x varies over rows)."""
    X = np.arange(H, dtype=np.float32) / (H - 1) * 2 - 1
    Y = np.arange(W, dtype=np.float32) / (W - 1) * 2 - 1
    xs, ys = np.meshgrid(X, Y, indexing="ij")
    return np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1)[None]


def get_rays(
    pose: np.ndarray,  # [4, 4] c2w
    intrinsics,  # (fx, fy, cx, cy)
    H: int,
    W: int,
    n_rays: int = -1,
    rng: np.random.RandomState | None = None,
    rect=None,  # (xmin, xmax, ymin, ymax): rows xmin..xmax, columns ymin..ymax
) -> dict:
    """Pinhole rays: the full frame (``n_rays < 0``), every pixel of
    ``rect`` in row-major order (``n_rays > 0``; no draw), or ``n_rays``
    uniform random pixels drawn from ``rng`` (required then). Returns
    ``rays_o/rays_d [N, 3]``, pixel indices ``inds`` and pixel-centre
    coords ``i`` (column) / ``j`` (row). The JAX helper's GRAF patch mode
    is not on any ported path."""
    fx, fy, cx, cy = [float(v) for v in intrinsics]
    pose = np.asarray(pose, np.float32)
    if n_rays > 0 and rect is not None:
        xmin, xmax, ymin, ymax = rect
        gx, gy = np.meshgrid(np.arange(xmin, xmax), np.arange(ymin, ymax), indexing="ij")
        inds = (gx * W + gy).reshape(-1)
    elif n_rays > 0:
        inds = rng.randint(0, H * W, min(n_rays, H * W))
    else:
        inds = np.arange(H * W)
    i = (inds % W).astype(np.float32) + 0.5
    j = (inds // W).astype(np.float32) + 0.5
    zs = np.ones_like(i)
    xs = (i - cx) / fx
    ys = (j - cy) / fy
    dirs = np.stack([xs, ys, zs], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays_d = dirs @ pose[:3, :3].T
    rays_o = np.broadcast_to(pose[:3, 3], rays_d.shape).copy()
    return {"rays_o": rays_o, "rays_d": rays_d, "inds": inds, "i": i, "j": j}


def get_rays_device(pose: torch.Tensor, intrinsics, inds: torch.Tensor, H: int, W: int):
    """:func:`get_rays` on the device for pixel indices ``inds [N]`` → (rays_o
    [N, 3], rays_d [N, 3], i [N], j [N])."""
    fx, fy, cx, cy = [float(v) for v in intrinsics]
    i = (inds % W).float() + 0.5
    j = torch.div(inds, W, rounding_mode="floor").float() + 0.5
    dirs = torch.stack([(i - cx) / fx, (j - cy) / fy, torch.ones_like(i)], dim=-1)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    rays_d = dirs @ pose[:3, :3].T
    rays_o = pose[:3, 3].expand_as(rays_d)
    return rays_o, rays_d, i, j


def bg_coords_device(inds: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Background coords in [-1, 1] of pixel indices (x varies over rows)."""
    xs = torch.div(inds, W, rounding_mode="floor").float() / (H - 1) * 2 - 1
    ys = (inds % W).float() / (W - 1) * 2 - 1
    return torch.stack([xs, ys], dim=-1)
