"""Lattice ray march over the bit-packed occupancy grid (port of the
unpaired path of ``geneface_tpu/ops/raymarch.py``).

In the uniform-dt regime (every face config: one cascade, ``grid_size >=
max_steps``) the reference CUDA walk visits exactly the lattice
``t0 + k*dt``, so marching is testing occupancy at lattice points: fast
forward each ray to the tight occupied box, test ``lattice_K`` points
against 8³-cell bit-packed blocks, and rank-select the first ``max_steps``
occupied points into a prefix-dense ``[N, max_steps]`` slab.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = [
    "near_far_from_aabb",
    "pack_occ_blocks",
    "occupied_cell_aabb",
    "march_rays_lattice",
    "MarchResult",
    "fma_f32",
]

_SQRT3 = math.sqrt(3.0)
_FMAX = torch.finfo(torch.float32).max


def near_far_from_aabb(
    rays_o: torch.Tensor,  # [N, 3]
    rays_d: torch.Tensor,  # [N, 3]
    aabb: torch.Tensor,  # [6] = (xmin, ymin, zmin, xmax, ymax, zmax)
    min_near: float = 0.05,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Slab-test ray/AABB intersection; misses get float32 max for both."""
    o = rays_o.float()
    d = rays_d.float()
    inv_d = 1.0 / d
    t0 = (aabb[:3] - o) * inv_d
    t1 = (aabb[3:] - o) * inv_d
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    miss = near > far
    near = near.clamp(min=min_near)
    return torch.where(miss, _FMAX, near), torch.where(miss, _FMAX, far)


class MarchResult(NamedTuple):
    ts: torch.Tensor  # [N, S] sample t, 0 where invalid
    dts: torch.Tensor  # [N, S] step size, 0 where invalid
    valid: torch.Tensor  # [N, S] bool, prefix-dense (slot j valid iff j < n_i)
    depth_ts: torch.Tensor  # [N, S] post-step t used for depth
    span: torch.Tensor  # [] int32: lattice steps any ray needs in the box
    ks: torch.Tensor  # [N, S] int32 lattice step of each sample
    t_start: torch.Tensor  # [N] per-ray lattice origin


def pack_occ_blocks(occ0: torch.Tensor) -> torch.Tensor:
    """Bit-pack a ``[H, H, H]`` bool grid into 8³-cell blocks → int32
    ``[(H/8)³, 16]`` (uint32 bit patterns): row ``b`` holds block ``b``
    (x-major order), in-block cell ``(ix, iy, iz)`` at word ``ix*2 + (iy>>2)``,
    bit ``(iy&3)*8 + iz``. A per-video constant of the occupancy grid."""
    H = occ0.shape[0]
    if H % 8:
        raise ValueError("grid size must be a multiple of the block size")
    B = H // 8
    r = occ0.reshape(B, 8, B, 2, 4, B, 8).to(torch.int64)
    iy = torch.arange(4, device=occ0.device).reshape(4, 1)
    iz = torch.arange(8, device=occ0.device).reshape(1, 8)
    w = (torch.ones((), dtype=torch.int64, device=occ0.device) << (iy * 8 + iz))
    words = (r * w.reshape(1, 1, 1, 1, 4, 1, 8)).sum(dim=(4, 6))  # [B, 8, B, 2, B]
    words = words.permute(0, 2, 4, 1, 3).reshape(B * B * B, 16)
    # two's-complement reinterpretation keeps the uint32 bit pattern
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def occupied_cell_aabb(occ0: torch.Tensor, bound: float) -> torch.Tensor:
    """Tight world AABB of occupied cells (+1-cell margin) → [6]; the full
    cube when the grid is empty."""
    H = occ0.shape[0]
    idx = torch.arange(H, dtype=torch.float32, device=occ0.device)
    mip_bound = min(1.0, bound)
    los, his = [], []
    for ax in ((1, 2), (0, 2), (0, 1)):
        any_i = occ0.any(dim=ax[1]).any(dim=ax[0])
        lo = torch.where(any_i, idx, float(H)).amin()
        hi = torch.where(any_i, idx, -1.0).amax()
        los.append(((lo - 1.0) / H * 2.0 - 1.0) * mip_bound)
        his.append(((hi + 2.0) / H * 2.0 - 1.0) * mip_bound)
    b = float(bound)
    full = torch.tensor([-b, -b, -b, b, b, b], device=occ0.device)
    empty = ~occ0.any()
    los = torch.where(empty, full[:3], torch.maximum(torch.stack(los), full[:3]))
    his = torch.where(empty, full[3:], torch.minimum(torch.stack(his), full[3:]))
    return torch.cat([los, his])


def fma_f32(a, b, c):
    """``a*b + c`` with one rounding to float32, as a fused multiply-add:
    the product of two float32 values is exact in float64. The JAX
    reference's compiler fuses these multiply-adds, and a lattice point on a
    cell boundary flips with the last bit of its position."""
    if not torch.is_tensor(b):  # a float32 constant, as the reference sees it
        b = float(torch.tensor(b, dtype=torch.float32))
    return (a.double() * b + c.double()).float()


def march_rays_lattice(
    rays_o: torch.Tensor,  # [N, 3]
    rays_d: torch.Tensor,  # [N, 3]
    blocks: torch.Tensor,  # [(H/8)^3, 16] from pack_occ_blocks
    tight: torch.Tensor,  # [6] from occupied_cell_aabb
    nears: torch.Tensor,  # [N] from the full training AABB (defines the lattice)
    fars: torch.Tensor,  # [N]
    noises: torch.Tensor,  # [N] in [0, 1)
    *,
    bound: float = 1.0,
    max_steps: int = 16,
    grid_size: int = 128,
    lattice_K: int = 32,
) -> MarchResult:
    """Exact uniform-dt march, one lattice test per (ray, step).

    ``blocks`` and ``tight`` depend on the occupancy grid only, so callers
    compute them once per video. The rank-select takes the first
    ``max_steps`` occupied lattice points of each ray by a cumsum over the
    ``[N, lattice_K]`` occupied mask.
    """
    N = rays_o.shape[0]
    H = grid_size
    K = lattice_K
    S = max_steps
    dt_max = 2.0 * _SQRT3 / H
    dt = min(dt_max, 2.0 * _SQRT3 / max_steps)
    if dt != dt_max:
        raise ValueError("lattice march requires the uniform-dt regime")
    mip_bound = min(1.0, bound)
    dev = rays_o.device
    o = rays_o.float()
    d = rays_d.float()

    t0 = fma_f32(noises, dt, nears)
    tn, tf = near_far_from_aabb(o, d, tight, 0.0)
    # fast-forward to the tight box on the original lattice
    k0 = torch.ceil((tn - t0).clamp(min=0.0) / dt - 1e-5)
    k0 = torch.where(tn > 1e30, float(2 * H), k0)  # miss -> everything masked
    t_start = fma_f32(k0, dt, t0)
    lo = torch.maximum(tn, nears)
    hi = torch.minimum(tf, fars)
    span_w = torch.where((tn < 1e30) & (hi > lo), hi - lo, 0.0)
    span = torch.ceil(span_w.amax() / dt).to(torch.int32) + 1

    ksf = torch.arange(K, dtype=torch.float32, device=dev)[None, :]
    ts = fma_f32(ksf, dt, t_start[:, None])  # [N, K]
    in_range = ts < torch.minimum(fars, tf + dt)[:, None]
    cell = []
    for a in range(3):
        p = fma_f32(ts, d[:, a : a + 1].double(), o[:, a : a + 1]).clamp(-bound, bound)
        cell.append(
            (0.5 * (p / mip_bound + 1.0) * H).clamp(0.0, float(H - 1)).to(torch.int64)
        )
    B = H // 8
    row = ((cell[0] >> 3) * B + (cell[1] >> 3)) * B + (cell[2] >> 3)
    ix, iy, iz = (c & 7 for c in cell)
    word = blocks.reshape(-1)[row * 16 + ((ix << 1) | (iy >> 2))].to(torch.int64)
    occ = ((word >> (((iy & 3) << 3) | iz)) & 1) > 0
    raw = occ & in_range  # [N, K]

    # rank-select: slot j takes the (j+1)-th occupied lattice point; points
    # past the S-th go to a spill column that is dropped
    rank = torch.cumsum(raw.to(torch.int32), dim=1) - 1
    slot = torch.where(raw & (rank < S), rank, S).to(torch.int64)
    kidx = torch.arange(K, dtype=torch.int32, device=dev).expand(N, K)
    ks = torch.zeros(N, S + 1, dtype=torch.int32, device=dev).scatter_(1, slot, kidx)[:, :S]
    n = raw.sum(dim=1).clamp(max=S)
    valid = torch.arange(S, device=dev)[None, :] < n[:, None]
    ks = torch.where(valid, ks, 0)
    ts_sel = fma_f32(ks, dt, t_start[:, None])
    return MarchResult(
        ts=torch.where(valid, ts_sel, 0.0),
        dts=torch.where(valid, dt, 0.0),
        valid=valid,
        depth_ts=torch.where(valid, ts_sel + dt, 0.0),
        span=span,
        ks=ks,
        t_start=t_start,
    )
