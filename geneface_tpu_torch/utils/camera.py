"""Camera math on the host (numpy copies of ``geneface_tpu/utils/camera.py``):
ngp pose conversion, 6-D pose vectors, background coordinates and full-frame
pinhole rays."""

from __future__ import annotations

import numpy as np

__all__ = ["nerf_matrix_to_ngp", "convert_poses", "get_bg_coords", "get_rays"]


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


def get_bg_coords(H: int, W: int) -> np.ndarray:
    """[1, H*W, 2] normalized pixel coords in [-1, 1] (x varies over rows)."""
    X = np.arange(H, dtype=np.float32) / (H - 1) * 2 - 1
    Y = np.arange(W, dtype=np.float32) / (W - 1) * 2 - 1
    xs, ys = np.meshgrid(X, Y, indexing="ij")
    return np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1)[None]


def get_rays(pose: np.ndarray, intrinsics, H: int, W: int) -> dict:
    """Full-frame pinhole rays: ``rays_o/rays_d [H*W, 3]`` plus pixel
    indices ``inds`` and pixel-centre coords ``i`` (column) / ``j`` (row).
    The inference path renders whole frames only, so the JAX helper's
    random/rect/patch sampling modes (training) are not copied."""
    fx, fy, cx, cy = [float(v) for v in intrinsics]
    pose = np.asarray(pose, np.float32)
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
