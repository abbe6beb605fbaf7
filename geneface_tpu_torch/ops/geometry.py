"""Geometry utilities (port of ``geneface_tpu/ops/geometry.py``):

- :func:`sph_from_ray`: the bounding-sphere intersection of rays →
  normalized (θ, φ) coordinates (the far root, as ``raymarching.cu``);
- :func:`linear_to_srgb` / :func:`srgb_to_linear`: the transfer functions;
- :func:`extract_fields` / :func:`extract_geometry`: a density field sampled
  on a dense grid, then its iso-surface by :func:`marching_tetrahedra`
  (numpy: each cell split into 6 tetrahedra around its main diagonal, exact
  linear interpolation on crossing edges, shared vertices merged). The
  vanilla NeRF family's mesh tool runs the field on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from geneface_tpu_torch import resolve_device

__all__ = [
    "sph_from_ray",
    "linear_to_srgb",
    "srgb_to_linear",
    "extract_fields",
    "extract_geometry",
    "marching_tetrahedra",
]


def sph_from_ray(rays_o: torch.Tensor, rays_d: torch.Tensor, radius: float) -> torch.Tensor:
    """Rays ``[N, 3]`` against the sphere of ``radius`` → ``[N, 2]``
    spherical coordinates in [-1, 1] (θ from the +y axis, φ in xz) of the
    larger root."""
    o = rays_o.float()
    d = rays_d.float()
    A = torch.sum(d * d, dim=-1)
    B = torch.sum(o * d, dim=-1)  # B/2 in the quadratic
    C = torch.sum(o * o, dim=-1) - radius * radius
    t = (-B + torch.sqrt(torch.clamp(B * B - A * C, min=0.0))) / A
    p = o + t[:, None] * d
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    theta = torch.atan2(torch.sqrt(x * x + z * z), y)  # [0, pi)
    phi = torch.atan2(z, x)  # [-pi, pi)
    return torch.stack([2.0 * theta / math.pi - 1.0, phi / math.pi], dim=-1)


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    """IEC 61966-2-1 with the reference's exponent 0.41666."""
    return torch.where(x < 0.0031308, 12.92 * x, 1.055 * x**0.41666 - 0.055)


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def extract_fields(bound_min, bound_max, resolution: int, query_func,
                   chunk: int = 128**3 // 4, device=None) -> np.ndarray:
    """``query_func(points [M, 3] on device) -> [M]`` on the dense
    ``resolution³`` grid over the bounds → float32 ``[R, R, R]``, in chunks
    of ``chunk`` points (``device`` defaults to the card)."""
    dev = resolve_device(device)
    bound_min = np.asarray(bound_min, np.float32)
    bound_max = np.asarray(bound_max, np.float32)
    axes = [np.linspace(bound_min[a], bound_max[a], resolution, dtype=np.float32)
            for a in range(3)]
    xx, yy, zz = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
    out = np.empty((pts.shape[0],), np.float32)
    with torch.no_grad():
        for lo in range(0, pts.shape[0], chunk):
            hi = min(lo + chunk, pts.shape[0])
            val = query_func(torch.as_tensor(pts[lo:hi], device=dev))
            out[lo:hi] = val.reshape(-1).float().cpu().numpy()
    return out.reshape(resolution, resolution, resolution)


# 6-tetrahedra split of the unit cell around the 0-7 diagonal; cube corners
# are indexed by bit pattern (x, y, z) -> 4*x + 2*y + z
_TETS = ((0, 5, 1, 7), (0, 1, 3, 7), (0, 3, 2, 7),
         (0, 2, 6, 7), (0, 6, 4, 7), (0, 4, 5, 7))
_CORNER_OFFSETS = np.array(
    [[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(8)], np.float32
)


def _tet_case_table():
    """mask (4-bit above/below pattern) → list of triangles, each triangle a
    triple of crossing edges (i, j) with vertex i below and j above."""
    table = {}
    for mask in range(1, 15):
        above = [i for i in range(4) if (mask >> i) & 1]
        below = [i for i in range(4) if not (mask >> i) & 1]
        if len(above) == 1:
            a = above[0]
            table[mask] = [tuple((b, a) for b in below)]
        elif len(above) == 3:
            b = below[0]
            table[mask] = [tuple((b, a) for a in above)]
        else:  # 2 above, 2 below -> quad -> 2 triangles
            a0, a1 = above
            b0, b1 = below
            e00, e01 = (b0, a0), (b1, a0)
            e10, e11 = (b0, a1), (b1, a1)
            table[mask] = [(e00, e01, e10), (e10, e01, e11)]
    return table


_CASES = _tet_case_table()


def marching_tetrahedra(u: np.ndarray, threshold: float):
    """Iso-surface of scalar field ``u`` [X, Y, Z] at ``threshold``.

    Returns (vertices [V, 3] float32 in index coordinates, triangles [T, 3]
    int32). Vertices are deduplicated across shared edges.
    """
    u = np.asarray(u, np.float32)
    X, Y, Z = u.shape
    cx, cy, cz = X - 1, Y - 1, Z - 1
    # base (corner-0) coordinates of every cell: [C, 3]
    gx, gy, gz = np.meshgrid(
        np.arange(cx), np.arange(cy), np.arange(cz), indexing="ij"
    )
    base = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    # corner values for every cell: [C, 8]
    vals = np.empty((base.shape[0], 8), np.float32)
    for c in range(8):
        ox, oy, oz = (c >> 2) & 1, (c >> 1) & 1, c & 1
        vals[:, c] = u[ox : ox + cx, oy : oy + cy, oz : oz + cz].reshape(-1)

    soup = []  # triangle soup chunks, each [t, 3, 3]
    for tet in _TETS:
        tv = vals[:, tet]  # [C, 4]
        mask = ((tv > threshold) * np.array([1, 2, 4, 8])).sum(-1)
        for case, tris in _CASES.items():
            sel = np.nonzero(mask == case)[0]
            if sel.size == 0:
                continue
            b = base[sel].astype(np.float32)  # [S, 3]
            v = tv[sel]  # [S, 4]
            for tri in tris:
                pts = []
                for (i, j) in tri:
                    vi, vj = v[:, i], v[:, j]
                    t = (threshold - vi) / np.where(
                        np.abs(vj - vi) < 1e-12, 1e-12, vj - vi
                    )
                    pi = b + _CORNER_OFFSETS[tet[i]]
                    pj = b + _CORNER_OFFSETS[tet[j]]
                    pts.append(pi + t[:, None] * (pj - pi))
                soup.append(np.stack(pts, axis=1))  # [S, 3, 3]

    if not soup:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    tris = np.concatenate(soup, axis=0)  # [T, 3, 3]
    flat = tris.reshape(-1, 3)
    # dedupe shared vertices (quantized keys: interpolation is exact per edge)
    keys = np.round(flat * 1e5).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    verts = np.zeros((uniq.shape[0], 3), np.float32)
    verts[inv] = flat
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate triangles (two corners on the same iso point)
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts, faces[ok]


def extract_geometry(bound_min, bound_max, resolution, threshold, query_func, device=None):
    """Density-field iso-surface → (vertices in world coordinates
    ``[V, 3]``, triangles ``[T, 3]``)."""
    u = extract_fields(bound_min, bound_max, resolution, query_func, device=device)
    vertices, triangles = marching_tetrahedra(u, threshold)
    b_min = np.asarray(bound_min, np.float32)
    b_max = np.asarray(bound_max, np.float32)
    vertices = vertices / (resolution - 1.0) * (b_max - b_min)[None, :] + b_min[None, :]
    return vertices, triangles
