"""Ray samplers of the vanilla NeRF family on the host (numpy copy of
``geneface_tpu/data/ray_samplers.py``): full-image rays in the OpenGL
convention (``-z`` forward, ``y`` up), uniform pixel sampling with a share of
the rays inside the face rect, the torso sampler (the lower image half by
default), every pixel (down-scaled by ``infer_scale_factor``), GRAF-style
square patches with a bilinear gather. The same ``RandomState`` gives the
same coordinates as the JAX package's samplers, bit for bit.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "get_rays_nerf",
    "UniformRaySampler",
    "TorsoUniformRaySampler",
    "FullRaySampler",
    "PatchRaySampler",
    "sample_pixels",
    "bilinear_sample_image",
]


def get_rays_nerf(H, W, focal, c2w, cx=None, cy=None):
    """Full-image rays, OpenGL convention (``ray_samplers.py:11-44``).
    Returns rays_o, rays_d with shape [H, W, 3]."""
    c2w = np.asarray(c2w, np.float32)
    cx = W * 0.5 if cx is None else cx
    cy = H * 0.5 if cy is None else cy
    i = np.arange(W, dtype=np.float32)[None, :].repeat(H, 0)
    j = np.arange(H, dtype=np.float32)[:, None].repeat(W, 1)
    dirs = np.stack(
        [(i - cx) / focal, -(j - cy) / focal, -np.ones_like(i)], axis=-1
    )
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    return rays_o, rays_d


def sample_pixels(img, coords):
    """img [H, W, C]; coords [N, 2] (row, col) → [N, C]."""
    return img[coords[:, 0], coords[:, 1]]


class UniformRaySampler:
    """Uniform pixel sampling, optionally rect-weighted
    (``ray_samplers.py:63-113``). ``rect = (w1, h1, dw, dh)``."""

    def __init__(self, n_rays=None, rng=None):
        self.n_rays = n_rays
        self.rng = rng or np.random

    def sample_coords(self, H, W, n_rays=None, rect=None, in_rect_percent=0.9):
        n_rays = n_rays or self.n_rays
        if rect is None:
            inds = self.rng.choice(H * W, size=n_rays, replace=False)
            return np.stack([inds // W, inds % W], axis=-1)
        w1, h1, dw, dh = rect
        w2, h2 = w1 + dw, h1 + dh
        rows = np.arange(H * W) // W
        cols = np.arange(H * W) % W
        in_rect = (rows >= h1) & (rows <= h2) & (cols >= w1) & (cols <= w2)
        rect_idx = np.flatnonzero(in_rect)
        out_idx = np.flatnonzero(~in_rect)
        n_in = int(n_rays * in_rect_percent)
        n_out = n_rays - n_in
        pick_in = self.rng.choice(len(rect_idx), size=min(n_in, len(rect_idx)), replace=False)
        pick_out = self.rng.choice(len(out_idx), size=min(n_out, len(out_idx)), replace=False)
        inds = np.concatenate([rect_idx[pick_in], out_idx[pick_out]])
        return np.stack([inds // W, inds % W], axis=-1)

    def __call__(self, H, W, focal, c2w, n_rays=None, rect=None,
                 in_rect_percent=0.9, cx=None, cy=None):
        rays_o, rays_d = get_rays_nerf(H, W, focal, c2w, cx, cy)
        coords = self.sample_coords(H, W, n_rays, rect, in_rect_percent)
        return rays_o[coords[:, 0], coords[:, 1]], rays_d[coords[:, 0], coords[:, 1]], coords


class TorsoUniformRaySampler(UniformRaySampler):
    """Defaults the rect to the lower image half (``ray_samplers.py:116-164``)."""

    def sample_coords(self, H, W, n_rays=None, rect=None, in_rect_percent=0.9):
        if rect is None:
            rect = (0, H / 2, W, H / 2)
        return super().sample_coords(H, W, n_rays, rect, in_rect_percent)


class FullRaySampler:
    """All pixels, optionally down-scaled by ``scale_factor``
    (``ray_samplers.py:167-189``)."""

    def __init__(self, scale_factor: float = 1.0):
        self.scale_factor = scale_factor

    def sample_coords(self, H, W):
        nh = int(H * self.scale_factor)
        nw = int(W * self.scale_factor)
        hs = np.linspace(0, H - 1, nh).astype(np.int64)
        ws = np.linspace(0, W - 1, nw).astype(np.int64)
        gh, gw = np.meshgrid(hs, ws, indexing="ij")
        return np.stack([gh.reshape(-1), gw.reshape(-1)], axis=-1)

    def __call__(self, H, W, focal, c2w, cx=None, cy=None):
        rays_o, rays_d = get_rays_nerf(H, W, focal, c2w, cx, cy)
        coords = self.sample_coords(H, W)
        return rays_o[coords[:, 0], coords[:, 1]], rays_d[coords[:, 0], coords[:, 1]], coords


def bilinear_sample_image(img, grid):
    """img [H, W, C]; grid [..., 2] float coords in [-1, 1] (x=w, y=h order
    as torch grid_sample, align_corners=True) → [..., C]."""
    H, W, _ = img.shape
    gx = (grid[..., 1] + 1) * 0.5 * (W - 1)  # grid[...,1] is w in torch order
    gy = (grid[..., 0] + 1) * 0.5 * (H - 1)
    x0 = np.clip(np.floor(gx).astype(np.int64), 0, W - 2)
    y0 = np.clip(np.floor(gy).astype(np.int64), 0, H - 2)
    wx = (gx - x0)[..., None]
    wy = (gy - y0)[..., None]
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (
        v00 * (1 - wx) * (1 - wy)
        + v01 * wx * (1 - wy)
        + v10 * (1 - wx) * wy
        + v11 * wx * wy
    )


class PatchRaySampler:
    """GRAF-style random square patch with float coordinates
    (``ray_samplers.py:192-290``); rays/pixels are bilinearly interpolated so
    the patch is differentiable-resolution. Used for adversarial/LPIPS
    training on contiguous regions."""

    def __init__(self, n_rays, min_scale=0.2, max_scale=1.0, rng=None):
        self.sqrt_n = int(math.sqrt(n_rays))
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.rng = rng or np.random

    def sample_grid(self, H, W, rect=None):
        lin = np.linspace(-1, 1, self.sqrt_n, dtype=np.float32)
        gw, gh = np.meshgrid(lin, lin, indexing="ij")
        scale = self.rng.uniform(self.min_scale, self.max_scale)
        h = gh * scale
        w = gw * scale
        if rect is None:
            max_off = 1 - scale
            h_off = self.rng.uniform(0, max_off) * (self.rng.randint(2) * 2 - 1)
            w_off = self.rng.uniform(0, max_off) * (self.rng.randint(2) * 2 - 1)
        else:
            w1, h1, dw, dh = rect
            w2, h2 = w1 + dw, h1 + dh
            min_w = max(scale - 1, (w1 - W // 2) / (W // 2))
            min_h = max(scale - 1, (h1 - H // 2) / (H // 2))
            max_w = min(1 - scale, (w2 - W // 2) / (W // 2))
            max_h = min(1 - scale, (h2 - H // 2) / (H // 2))
            h_off = self.rng.uniform(min_h, max(min_h, max_h))
            w_off = self.rng.uniform(min_w, max(min_w, max_w))
        return np.stack([h + h_off, w + w_off], axis=-1)  # [S, S, 2]

    def __call__(self, H, W, focal, c2w, rect=None, cx=None, cy=None):
        rays_o, rays_d = get_rays_nerf(H, W, focal, c2w, cx, cy)
        grid = self.sample_grid(H, W, rect)
        ro = bilinear_sample_image(rays_o, grid).reshape(-1, 3)
        rd = bilinear_sample_image(rays_d, grid).reshape(-1, 3)
        return ro, rd, grid
