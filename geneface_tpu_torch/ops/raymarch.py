"""Ray marching and slab compositing (port of ``geneface_tpu/ops/raymarch.py``:
the unpaired lattice march, the walk and the slab composite).

In the uniform-dt regime (every face config: one cascade, ``grid_size >=
max_steps``) the reference CUDA walk visits exactly the lattice
``t0 + k*dt``, so marching is testing occupancy at lattice points: fast
forward each ray to the tight occupied box, test ``lattice_K`` points
against 8³-cell bit-packed blocks, and rank-select the first ``max_steps``
occupied points into a prefix-dense ``[N, max_steps]`` slab
(:func:`march_rays_lattice`, the compact render path).

:func:`march_rays_train` is the walk itself, one step of every ray per
iteration, as the JAX package's ``while_loop``; the training render of the
torso task's frozen head takes it, with :func:`composite_rays` over the
whole ``[N, max_steps]`` slab.
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
    "march_rays_train",
    "composite_rays",
    "MarchResult",
    "fma_f32",
]

_SQRT3 = math.sqrt(3.0)
_FMAX = torch.finfo(torch.float32).max
#: walk iterations between the host's checks for a live ray
_CHECK_EVERY = 8


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
    # lattice march only (None from the walk):
    span: torch.Tensor | None = None  # [] int32: lattice steps any ray needs in the box
    ks: torch.Tensor | None = None  # [N, S] int32 lattice step of each sample
    t_start: torch.Tensor | None = None  # [N] per-ray lattice origin


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
    c = c.double() if torch.is_tensor(c) else float(torch.tensor(c, dtype=torch.float32))
    return (a.double() * b + c).float()


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


def _skip_bytes(occ0: torch.Tensor) -> torch.Tensor:
    """Chebyshev skip field of a ``[H, H, H]`` bool grid → ``[H³]`` int64:
    bit 0 is the cell's occupancy, bit ``k`` (1..4) says that an occupied
    cell lies within Chebyshev radius ``2^k - 1``. The lowest zero bit
    gives a radius whose whole box is empty, so the walk may jump to the
    box's exit without passing an occupied lattice point."""
    x = occ0.float()[None, None]
    byte = occ0.reshape(-1).to(torch.int64)
    # box radii add up under chaining: 1, 1+2, 3+4, 7+8, each separable
    for bit, r in enumerate((1, 2, 4, 8), start=1):
        for axis in range(3):
            k = [1, 1, 1]
            k[axis] = 2 * r + 1
            pad = [0, 0, 0]
            pad[axis] = r
            x = torch.nn.functional.max_pool3d(x, tuple(k), stride=1, padding=tuple(pad))
        byte = byte | (x.reshape(-1).to(torch.int64) << bit)
    return byte


def _exponent(x: torch.Tensor) -> torch.Tensor:
    """Binary exponent ``e`` of ``x = m·2^e``, ``m`` in [0.5, 1) (``frexp``
    of ``max(x, 1e-30)``)."""
    return torch.frexp(x.clamp(min=1e-30)).exponent


def march_rays_train(
    rays_o: torch.Tensor,  # [N, 3]
    rays_d: torch.Tensor,  # [N, 3]
    occ_grid: torch.Tensor,  # [cascade, H, H, H] bool
    nears: torch.Tensor,  # [N]
    fars: torch.Tensor,  # [N]
    noises: torch.Tensor,  # [N] in [0, 1): jitter of the start t
    *,
    bound: float = 1.0,
    dt_gamma: float = 0.0,
    max_steps: int = 16,
    grid_size: int = 128,
) -> MarchResult:
    """The walk of the reference CUDA march (``kernel_march_rays_train``):
    start at ``near + dt(near)·noise``; at an occupied cell emit a sample and
    step ``dt = clamp(t·dt_gamma, dt_min, dt_max)``; at an empty cell skip
    to the next voxel boundary in ``dt`` micro-steps. Every iteration
    advances every live ray once, for at most ``2·H + 2·max_steps``
    iterations (the JAX package's cap).

    Two branches, as in the JAX package. In the uniform-dt regime (every
    face config: one cascade and ``grid_size >= max_steps``) one iteration
    jumps a whole empty region along the ray's lattice, as far as
    :func:`_skip_bytes` proves empty:
    ``t += max(1, ceil((target - t)/dt - 1e-5))·dt``. Otherwise each
    iteration takes one micro-step of the do-while. With ``C > 1``
    cascades (``bound > 1``) the step reaches ``dt_max = 2√3·2^(C-1)/H``
    and each sample reads the cascade ``max(exponent(max|pos|),
    exponent(dt·H/2))`` (``frexp`` exponents, clipped to ``[0, C-1]``),
    whose cells span ``min(2^level, bound)``. Positions ``o + t·d`` and the
    lattice steps round once, as the reference compiler's fused
    multiply-adds do. The host reads whether any ray is still live every
    ``_CHECK_EVERY`` iterations (iterations past that change nothing).
    """
    N = rays_o.shape[0]
    S = max_steps
    H = grid_size
    dev = rays_o.device
    o = rays_o.detach().float()
    d = rays_d.detach().float()
    inv_d = 1.0 / d
    C = occ_grid.shape[0]
    dt_max = 2.0 * _SQRT3 * (1 << (C - 1)) / H
    dt_min = min(dt_max, 2.0 * _SQRT3 / max_steps)
    uniform = dt_min == dt_max and C == 1
    mb = min(1.0, bound)
    strides = torch.tensor([H * H, H, 1], device=dev)

    def dt_of(t):
        return (t * dt_gamma).clamp(dt_min, dt_max)

    t = fma_f32(dt_of(nears), noises.float(), nears)
    n_valid = torch.zeros(N, dtype=torch.int64, device=dev)
    # (t, dt, t + dt) of each slot, and one spill slot that rays which emit
    # nothing write to
    buf = torch.zeros(N, S + 1, 3, device=dev)
    if uniform:
        byte = _skip_bytes(occ_grid[0])
        dt = float(torch.tensor(dt_min, dtype=torch.float32))
        cs = 2.0 * mb / H
        # bits 1..4 of the skip byte → the largest 2^k - 1 whose bit is clear
        radius = torch.tensor(
            [15.0 if not v & 8 else 7.0 if not v & 4 else 3.0 if not v & 2 else
             1.0 if not v & 1 else 0.0 for v in range(16)], device=dev,
        )
    else:
        grid_flat = occ_grid.reshape(-1)  # [C·H³]: cascade c starts at c·H³
        tt_target = torch.full((N,), -math.inf, device=dev)
    for it in range(2 * H + 2 * S):
        alive = (t < fars) & (n_valid < S)
        if it % _CHECK_EVERY == 0 and not bool(alive.any()):
            break
        pos = fma_f32(t[:, None], d, o).clamp(-bound, bound)  # [N, 3]
        if uniform:
            cell = (0.5 * (pos / mb + 1.0) * H).clamp(0.0, float(H - 1)).to(torch.int64)
            lin = (cell * strides).sum(dim=-1)
            cf = cell.float()
            b = byte[lin]
            occ = (b & 1) > 0
            r = radius[(b >> 1) & 15][:, None]
            # the exit of the empty box [cell - r, cell + r] along the ray
            face = fma_f32(torch.where(d > 0, cf + r + 1.0, cf - r), cs, -mb)
            target = t + ((face - pos) * inv_d).amin(dim=-1).clamp(min=0.0)
            emit = alive & occ
            step = torch.full_like(t, dt)
        else:
            step = dt_of(t)
            if C > 1:  # the cascade of each sample's position and step
                level = torch.maximum(
                    _exponent(pos.abs().amax(dim=-1)).clamp(0, C - 1),
                    _exponent(step * H * 0.5).clamp(0, C - 1),
                ).to(torch.int64)
                mip_bound = torch.exp2(level.float()).clamp(max=bound)[:, None]
            else:
                level, mip_bound = 0, mb
            cell = (0.5 * (pos * (1.0 / mip_bound) + 1.0) * H).clamp(0.0, float(H - 1))
            cell = cell.to(torch.int64)
            occ = grid_flat[level * H**3 + (cell * strides).sum(dim=-1)]
            pending = t < tt_target
            face = fma_f32(cell.float() + 0.5 + 0.5 * torch.sign(d), 2.0 / H, -1.0) * mip_bound
            t_skip = ((face - pos) * inv_d).amin(dim=-1)
            emit = alive & ~pending & occ
            # start a skip at an empty cell; keep the old target otherwise
            tt_target = torch.where(alive & ~pending & ~occ, t + t_skip.clamp(min=0.0), tt_target)
        slot = torch.where(emit, n_valid, S)[:, None, None].expand(N, 1, 3)
        buf.scatter_(1, slot, torch.stack([t, step, t + step], dim=-1)[:, None, :])
        n_valid = n_valid + emit.to(torch.int64)
        if uniform:
            # lattice-preserving jump past the whole empty region
            k = torch.ceil((target - t) / dt - 1e-5).clamp(min=1.0)
            t = torch.where(alive, torch.where(occ, t + dt, fma_f32(k, dt, t)), t)
        else:
            t = torch.where(alive, t + step, t)
    valid = torch.arange(S, device=dev)[None, :] < n_valid[:, None]
    ts, dts, dpts = buf[:, :S].unbind(dim=-1)
    return MarchResult(ts=ts, dts=dts, valid=valid, depth_ts=dpts)


def composite_rays(
    sigmas: torch.Tensor,  # [N, S]
    rgbs: torch.Tensor,  # [N, S, 3]
    dts: torch.Tensor,  # [N, S]
    depth_ts: torch.Tensor,  # [N, S]
    valid: torch.Tensor,  # [N, S] bool
    ambients: torch.Tensor | None = None,  # [N, S] per-sample ambient norm
    T_thresh: float = 1e-4,
) -> dict:
    """Front-to-back compositing over padded slabs:
    ``T_k = exp(-Σ_{j<k} σ_j·dt_j)`` (an exclusive cumsum), weights
    ``α_k·T_k`` for the samples with ``T_k >= T_thresh`` (a mask without a
    gradient: the reference loop stops after the sample that crosses the
    threshold), and the ambient norm summed unweighted over those samples.
    → image [N, 3], weights_sum, depth, ambient_sum [N], weights [N, S]."""
    sd = torch.where(valid, sigmas * dts, 0.0)
    cum = torch.cumsum(sd, dim=-1)
    T_before = torch.exp(-(cum - sd))
    alpha = 1.0 - torch.exp(-sd)
    include = (T_before >= T_thresh).detach() & valid
    weights = torch.where(include, alpha * T_before, 0.0)
    out = {
        "image": (weights[..., None] * rgbs).sum(dim=1),
        "weights_sum": weights.sum(dim=-1),
        "depth": (weights * depth_ts).sum(dim=-1),
        "weights": weights,
    }
    if ambients is not None:
        out["ambient_sum"] = torch.where(include, ambients, 0.0).sum(dim=-1)
    return out
