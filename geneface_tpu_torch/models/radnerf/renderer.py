"""Occupancy state, k-DOP ray cull, the compact and the slab render paths
and the torso composite (port of ``geneface_tpu/models/radnerf/renderer.py``).

A frame runs: the 13-slab k-DOP cull of the full frame; the lattice march of
the kept rays; waterfilled compaction; one ``[Mc, 8]`` record gather; the
field; front-to-back compositing in compact space; and the scatter of the
kept rays back to the frame. The per-ray sums of the composite and the frame
scatter are both row scatter-adds, i.e. the CUDA kernel behind
:func:`geneface_tpu_torch.ops.scatter_add_rows`, which is differentiable
(its backward is the row gather kernel).

Training renders a ray batch without the cull, with the march jittered by
per-ray ``noises`` and stop-gradient rays; the occupancy state starts from
:func:`init_occupancy` + :func:`mark_untrained_grid` and is refreshed by
:func:`update_extra_state`.

Without ``mean_samples_per_ray`` a ray batch renders through the walk
(:func:`march_rays_train`), the field on the whole ``[N, max_steps]`` slab
and :func:`composite_rays` (the padded slab: the import config's route, and
the torso task's frozen head's); with it but without ``lattice_K`` the walk
feeds the compaction, as in the JAX renderer. :func:`render_rays_radnerf_torso` composites the head
over the torso and the torso over the background, with the 2-D torso
occupancy of :class:`TorsoOccupancyState`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import logging
import math

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from geneface_tpu_torch.models.radnerf.radnerf_torso import sample_torso_occupancy
from geneface_tpu_torch.ops import (
    compact_gather,
    composite_rays,
    dilate_grid3d,
    make_compact_plan,
    march_rays_lattice,
    march_rays_train,
    near_far_from_aabb,
    occupied_cell_aabb,
    pack_occ_blocks,
    scatter_add_rows,
    segmented_cumsum,
    waterfill_valid,
)
from geneface_tpu_torch.ops.raymarch import fma_f32

__all__ = [
    "OccupancyState",
    "init_occupancy",
    "mark_untrained_grid",
    "update_extra_state",
    "make_aabb",
    "occupied_kdop",
    "kdop_hit",
    "OccupancyView",
    "occupancy_view",
    "render_rays_radnerf",
    "TorsoOccupancyState",
    "init_torso_occupancy",
    "update_torso_occupancy",
    "torso_occupancy_mask",
    "render_rays_radnerf_torso",
]


class OccupancyState(NamedTuple):
    """Density EMA grid ``[cascade, H³]``, boolean occupancy
    ``[cascade, H, H, H]`` and the running mean density (scalar)."""

    density_grid: object
    occ_grid: object
    mean_density: object


def make_aabb(bound: float, device=None) -> torch.Tensor:
    """Training AABB: full cube in x/z, half height in y."""
    b = float(bound)
    return torch.tensor([-b, -b / 2, -b, b, b / 2, b], dtype=torch.float32, device=device)


def _cell_centers(grid_size: int) -> np.ndarray:
    """[H³, 3] cell-centre coordinates in [-1, 1] (x-major)."""
    r = np.arange(grid_size, dtype=np.float32)
    xx, yy, zz = np.meshgrid(r, r, r, indexing="ij")
    coords = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
    return 2.0 * coords / (grid_size - 1) - 1.0


def cascade_of(bound: float) -> int:
    return 1 + math.ceil(math.log2(max(bound, 1.0)))


def init_occupancy(grid_size: int, bound: float, device=None) -> OccupancyState:
    """All-zero density grid, empty occupancy, zero mean density."""
    C = cascade_of(bound)
    return OccupancyState(
        density_grid=torch.zeros(C, grid_size**3, device=device),
        occ_grid=torch.zeros(C, grid_size, grid_size, grid_size, dtype=torch.bool, device=device),
        mean_density=torch.zeros((), device=device),
    )


def mark_untrained_grid(
    occ: OccupancyState,
    poses: np.ndarray,  # [B, 4, 4] c2w
    intrinsics,  # (fx, fy, cx, cy)
    grid_size: int,
    bound: float,
) -> OccupancyState:
    """Mark the cells outside every training camera's frustum with density
    -1. Host numpy, once at start-up."""
    fx, fy, cx, cy = [float(v) for v in intrinsics]
    poses = np.asarray(poses, np.float32)
    C = occ.density_grid.shape[0]
    world = _cell_centers(grid_size)
    grid = occ.density_grid.detach().cpu().numpy().copy()
    for cas in range(C):
        cas_bound = min(2**cas, bound)
        half_cell = cas_bound / grid_size
        pts = world * (cas_bound - half_cell)
        covered = np.zeros(len(pts), np.int64)
        for head in range(0, len(poses), 64):
            p = poses[head : head + 64]
            rel = pts[None, :, :] - p[:, None, :3, 3]
            cam = np.einsum("bnd,bdk->bnk", rel, p[:, :3, :3])  # world -> cam
            mask = (
                (cam[..., 2] > 0)
                & (np.abs(cam[..., 0]) < cx / fx * cam[..., 2] + half_cell * 2)
                & (np.abs(cam[..., 1]) < cy / fy * cam[..., 2] + half_cell * 2)
            )
            covered += mask.sum(0)
        grid[cas, covered == 0] = -1.0
    return occ._replace(
        density_grid=torch.as_tensor(grid, device=occ.density_grid.device)
    )


@torch.no_grad()
def update_extra_state(
    density_fn: Callable,  # xyz [M, 3] -> sigma [M]
    occ: OccupancyState,
    noise: torch.Tensor,  # [cascade, H³, 3] uniform in [0, 1)
    *,
    grid_size: int,
    bound: float,
    density_thresh: float,
    decay: float = 0.95,
    chunks: int = 16,
) -> OccupancyState:
    """Density sweep at jittered cell centres (in ``chunks`` field calls) →
    3³ max-pool dilation → decayed-max EMA → threshold at
    ``min(mean density, density_thresh)``. The jitter arrives as ``noise``.
    """
    C = occ.density_grid.shape[0]
    H = grid_size
    world = torch.as_tensor(_cell_centers(H), device=occ.density_grid.device)
    rows = []
    for cas in range(C):
        cas_bound = min(2**cas, bound)
        half_cell = cas_bound / H
        pts = world * (cas_bound - half_cell) + (noise[cas] * 2 - 1) * half_cell
        rows.append(torch.cat([density_fn(c).float() for c in pts.chunk(chunks)]))
    tmp = dilate_grid3d(torch.stack(rows).reshape(C, H, H, H)).reshape(C, -1)
    valid = (occ.density_grid >= 0) & (tmp >= 0)
    density = torch.where(valid, torch.maximum(occ.density_grid * decay, tmp), occ.density_grid)
    mean_density = density.clamp(min=0.0).mean()
    thresh = torch.clamp(mean_density, max=density_thresh)
    return OccupancyState(density, (density > thresh).reshape(C, H, H, H), mean_density)


#: k-DOP direction set: 3 axes + 6 face diagonals + 4 body diagonals
_KDOP_DIRS = np.asarray(
    [
        [1, 0, 0], [0, 1, 0], [0, 0, 1],
        [1, 1, 0], [1, -1, 0], [1, 0, 1], [1, 0, -1], [0, 1, 1], [0, 1, -1],
        [1, 1, 1], [1, 1, -1], [1, -1, 1], [1, -1, -1],
    ],
    np.float32,
)


def occupied_kdop(occ_grid: torch.Tensor, bound: float) -> tuple[torch.Tensor, torch.Tensor]:
    """13-slab k-DOP bounds (lo [13], hi [13]) of the occupied fine cells,
    grown by each cell's projected extent (+1 cell), so every occupied cell
    lies inside every slab; the training AABB's k-DOP for an empty grid."""
    g = occ_grid[0]
    H = g.shape[0]
    dev = g.device
    mip_bound = min(1.0, bound)
    dirs = torch.as_tensor(_KDOP_DIRS, device=dev)
    centers = torch.as_tensor(_cell_centers(H), device=dev) * mip_bound
    proj = centers @ dirs.T  # [H^3, 13]
    occ = g.reshape(-1, 1)
    lo = torch.where(occ, proj, 1e30).amin(dim=0)
    hi = torch.where(occ, proj, -1e30).amax(dim=0)
    half = (2.0 * mip_bound / H) * dirs.abs().sum(dim=-1)
    lo, hi = lo - half, hi + half
    full = make_aabb(bound, dev)
    corners = torch.stack(
        [
            torch.stack([full[3 * (i % 2)], full[1 + 3 * ((i >> 1) % 2)],
                         full[2 + 3 * ((i >> 2) % 2)]])
            for i in range(8)
        ]
    )
    cproj = corners @ dirs.T
    empty = ~g.any()
    lo = torch.where(empty, cproj.amin(dim=0), lo)
    hi = torch.where(empty, cproj.amax(dim=0), hi)
    return lo, hi


def kdop_hit(rays_o, rays_d, kdop, min_near: float) -> torch.Tensor:
    """[N] bool: the ray segment beyond ``min_near`` meets the k-DOP."""
    lo, hi = kdop
    dirs = torch.as_tensor(_KDOP_DIRS, device=rays_o.device)
    od = rays_o.float() @ dirs.T  # [N, 13]
    dd = rays_d.float() @ dirs.T
    dd = torch.where(dd.abs() < 1e-12, 1e-12, dd)
    t0 = (lo[None, :] - od) / dd
    t1 = (hi[None, :] - od) / dd
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    return (near.clamp(min=min_near) <= far) & (far >= min_near)


#: (cascade, grid_size, max_steps) whose fall-back to the walk was logged
_WARNED: set = set()


class OccupancyView(NamedTuple):
    """Per-video constants derived from the occupancy grid: the packed 8³
    blocks the lattice march tests, the tight occupied box it fast-forwards
    to (both ``None`` for more than one cascade, which only the walk
    marches), and the grid itself, which the walk reads."""

    blocks: torch.Tensor | None  # [(H/8)^3, 16] int32
    tight: torch.Tensor | None  # [6]
    grid: torch.Tensor  # [cascade, H, H, H] bool


def occupancy_view(occ_grid: torch.Tensor, bound: float) -> OccupancyView:
    """Pack ``occ_grid [cascade, H, H, H]`` for :func:`render_rays_radnerf`:
    the lattice march's blocks and box of a single cascade."""
    if occ_grid.shape[0] != 1:
        return OccupancyView(None, None, occ_grid)
    return OccupancyView(
        pack_occ_blocks(occ_grid[0]), occupied_cell_aabb(occ_grid[0], bound), occ_grid
    )


def render_rays_radnerf(
    field_fn: Callable,  # (xyz [M,3], dirs [M,3]) -> (sigma [M], rgb [M,3], ambient [M,2])
    rays_o: torch.Tensor,  # [N, 3]
    rays_d: torch.Tensor,  # [N, 3]
    occ: OccupancyView,
    *,
    bound: float,
    min_near: float,
    max_steps: int,
    grid_size: int,
    lattice_K: int | None = None,
    mean_samples_per_ray: float | None = None,
    dt_gamma: float = 1.0 / 256,
    bg_color: torch.Tensor | float = 1.0,
    T_thresh: float = 1e-4,
    ray_capacity: int | None = None,
    cull_kdop: tuple | None = None,
    noises: torch.Tensor | None = None,
    group=None,
) -> dict:
    """March + field eval + composite + background.

    With ``mean_samples_per_ray``: the compact field eval, after the
    lattice march where ``lattice_K`` is set, the grid has one cascade and
    ``grid_size >= max_steps`` (the uniform-dt regime), else after the walk
    (logged once, as the JAX renderer warns). Without it: the walk and
    the field on the whole ``[N, max_steps]`` slab. ``dt_gamma`` sets the
    walk's step beyond the uniform-dt regime; after the walk
    ``march_span`` is ``None``.

    With ``ray_capacity`` (and ``cull_kdop``) only the first
    ``ray_capacity`` rays that meet the k-DOP are rendered; overflow rays
    render as background, as in the JAX renderer. ``noises [N]`` in [0, 1)
    jitter the march (training); ``None`` marches unjittered (inference).
    Rays carry no gradient. Returns rgb_map [N, 3], depth_map, weights_sum,
    ambient_sum [N], ``n_samples`` [rendered rays] and ``march_span`` (the
    lattice steps any ray needed, the signal that retunes ``lattice_K``).

    ``group`` (a training step split over ranks): these rays are this
    rank's block of a global batch of ``N × ranks`` rays; the sample budget
    is the global batch's, waterfilled over all ranks
    (:func:`waterfill_valid`), and this rank's compact buffer holds what it
    keeps, padded to a multiple of 1,024 slots (one host read).
    """
    N = rays_o.shape[0]
    dev = rays_o.device
    common = dict(
        bound=bound, min_near=min_near, max_steps=max_steps, grid_size=grid_size,
        lattice_K=lattice_K, mean_samples_per_ray=mean_samples_per_ray,
        dt_gamma=dt_gamma, T_thresh=T_thresh,
    )
    if ray_capacity:
        if cull_kdop is None:
            raise ValueError("ray_capacity needs cull_kdop (see occupied_kdop)")
        C = min(int(ray_capacity), N)
        with record_function("gf::cull"):
            hit = kdop_hit(rays_o, rays_d, cull_kdop, min_near)
            # the first C hit rays, padded with the dropped index N
            idx = torch.full((C,), N, dtype=torch.int64, device=dev)
            found = torch.nonzero(hit)[:C, 0]
            idx[: found.shape[0]] = found
            safe = idx.clamp(max=N - 1)
        inner = render_rays_radnerf(
            field_fn, rays_o[safe], rays_d[safe], occ, bg_color=0.0,
            noises=None if noises is None else noises[safe], **common,
        )
        with record_function("gf::frame_scatter"):
            packed = torch.cat(
                [
                    inner["rgb_map"],
                    inner["weights_sum"][:, None],
                    inner["depth_map"][:, None],
                    inner["ambient_sum"][:, None],
                ],
                dim=-1,
            )  # [C, 6]
            # unique rows (pad rows N are dropped): the scatter-add is exact
            full = scatter_add_rows(idx.to(torch.int32), packed, N, site="frame_scatter")
            rgb, ws, depth, amb = full[:, 0:3], full[:, 3], full[:, 4], full[:, 5]
            image = (rgb + (1.0 - ws)[:, None] * bg_color).clamp(0.0, 1.0)
        return {
            "rgb_map": image,
            "depth_map": depth,
            "weights_sum": ws,
            "ambient_sum": amb,
            "n_samples": inner["n_samples"],
            "march_span": inner["march_span"],
        }

    if not mean_samples_per_ray:
        return _render_slab(field_fn, rays_o, rays_d, occ, noises, bg_color, **common)
    with record_function("gf::march"):
        rays_o, rays_d = rays_o.detach(), rays_d.detach()
        nears, fars = near_far_from_aabb(rays_o, rays_d, make_aabb(bound, dev), min_near)
        if noises is None:
            noises = torch.zeros(N, device=dev)
        # the lattice march needs the uniform-dt regime (one cascade and
        # grid_size >= max_steps); without it, or without lattice_K, the walk
        uniform = occ.grid.shape[0] == 1 and grid_size >= max_steps
        if lattice_K and not uniform and (occ.grid.shape[0], grid_size, max_steps) not in _WARNED:
            _WARNED.add((occ.grid.shape[0], grid_size, max_steps))
            logging.getLogger("geneface_tpu_torch").warning(
                "lattice_K=%s requested but falling back to the walk (cascade=%d, "
                "grid_size=%d, max_steps=%d)", lattice_K, occ.grid.shape[0], grid_size,
                max_steps,
            )
        if lattice_K and uniform:
            march = march_rays_lattice(
                rays_o, rays_d, occ.blocks, occ.tight, nears, fars, noises,
                bound=bound, max_steps=max_steps, grid_size=grid_size, lattice_K=lattice_K,
            )
        else:
            march = march_rays_train(
                rays_o.float(), rays_d.float(), occ.grid, nears, fars, noises,
                bound=bound, dt_gamma=dt_gamma, max_steps=max_steps, grid_size=grid_size,
            )
    with record_function("gf::compact"):
        S = march.ts.shape[-1]
        # compact-eval capacity: the sample budget, padded to a multiple of
        # 1024 and never beyond the full slab
        ranks = 1 if group is None else dist.get_world_size(group)
        capacity = min(int(-(-N * ranks * float(mean_samples_per_ray) // 1024) * 1024),
                       N * ranks * S)
        keep = waterfill_valid(march.valid, capacity, group)
        if ranks > 1:
            capacity = min(max(-(-int(keep.sum()) // 1024), 1) * 1024, N * S)
        plan = make_compact_plan(keep, capacity)
        # ONE [Mc, 8] record gather for everything per sample
        ro = rays_o.float()[:, None, :]
        rd = rays_d.float()[:, None, :]
        xyz_slab = fma_f32(march.ts[..., None], rd, ro)  # [N, S, 3], one rounding
        rec = torch.cat(
            [
                march.dts[..., None],
                march.depth_ts[..., None],
                xyz_slab,
                rd.expand_as(xyz_slab),
            ],
            dim=-1,
        )
        rec_c = compact_gather(plan, rec)  # [Mc, 8]
        dt_c, dep_c = rec_c[:, 0], rec_c[:, 1]
        xyz_c = rec_c[:, 2:5].clamp(-bound, bound)
    with record_function("gf::field"):
        sigma_c, rgb_c, ambient_c = field_fn(xyz_c, rec_c[:, 5:8])
        amb_c = ambient_c.abs().sum(dim=-1)

    with record_function("gf::composite"):
        # front-to-back compositing in compact space
        sd = torch.where(plan.valid, sigma_c * dt_c, 0.0)
        pref = segmented_cumsum(sd, plan.is_start)  # within-ray inclusive prefix
        T_before = torch.exp(-(pref - sd))
        alpha = 1.0 - torch.exp(-sd)
        include = (T_before >= T_thresh) & plan.valid
        w = torch.where(include, alpha * T_before, 0.0)
        cols = torch.stack(
            [w, w * rgb_c[:, 0], w * rgb_c[:, 1], w * rgb_c[:, 2], w * dep_c,
             torch.where(include, amb_c, 0.0)],
            dim=-1,
        )  # [Mc, 6]
        # per-ray sums: every valid slot adds its row to its ray; waterfilling
        # keeps total <= Mc, so each ray's samples all lie inside capacity
        rows = torch.where(plan.valid, plan.ray, -1).to(torch.int32)
        sums = scatter_add_rows(rows, cols, N, site="composite_sums")  # [N, 6]
        weights_sum = sums[:, 0]
        image = (sums[:, 1:4] + (1.0 - weights_sum)[:, None] * bg_color).clamp(0.0, 1.0)
        span = (fars - nears).clamp(min=1e-6)
        depth = torch.where(nears < 1e30, (sums[:, 4] - nears).clamp(min=0.0) / span, 0.0)
    return {
        "rgb_map": image,
        "depth_map": depth,
        "weights_sum": weights_sum,
        "ambient_sum": sums[:, 5],
        "n_samples": plan.n,
        "march_span": march.span,
    }


def _render_slab(field_fn, rays_o, rays_d, occ: OccupancyView, noises, bg_color, *,
                 bound, min_near, max_steps, grid_size, dt_gamma, T_thresh, **_) -> dict:
    """The walk, the field on every slot of the ``[N, max_steps]`` slab and
    :func:`composite_rays` (the JAX renderer's route without compaction)."""
    N = rays_o.shape[0]
    dev = rays_o.device
    with record_function("gf::march"):
        ro, rd = rays_o.detach().float(), rays_d.detach().float()
        nears, fars = near_far_from_aabb(ro, rd, make_aabb(bound, dev), min_near)
        if noises is None:
            noises = torch.zeros(N, device=dev)
        march = march_rays_train(
            ro, rd, occ.grid, nears, fars, noises, bound=bound, dt_gamma=dt_gamma,
            max_steps=max_steps, grid_size=grid_size,
        )
    with record_function("gf::field"):
        S = march.ts.shape[-1]
        xyz = fma_f32(march.ts[..., None], rd[:, None, :], ro[:, None, :]).clamp(-bound, bound)
        dirs = rd[:, None, :].expand_as(xyz)
        sigma, rgb, ambient = field_fn(xyz.reshape(-1, 3), dirs.reshape(-1, 3))
    with record_function("gf::composite"):
        comp = composite_rays(
            sigma.reshape(N, S), rgb.reshape(N, S, 3), march.dts, march.depth_ts, march.valid,
            ambients=ambient.abs().sum(dim=-1).reshape(N, S), T_thresh=T_thresh,
        )
        ws = comp["weights_sum"]
        image = (comp["image"] + (1.0 - ws)[:, None] * bg_color).clamp(0.0, 1.0)
        span = (fars - nears).clamp(min=1e-6)
        depth = torch.where(nears < 1e30, (comp["depth"] - nears).clamp(min=0.0) / span, 0.0)
    return {
        "rgb_map": image,
        "depth_map": depth,
        "weights_sum": ws,
        "ambient_sum": comp["ambient_sum"],
        "n_samples": march.valid.sum(dim=-1),
        "march_span": None,
    }


# ------------------------------------------------------------------ torso ----
class TorsoOccupancyState(NamedTuple):
    """2-D torso alpha grid ``[H*H]`` (row = y, column = x) and its mean."""

    density_grid: object
    mean_density: object


def init_torso_occupancy(grid_size: int, device=None) -> TorsoOccupancyState:
    return TorsoOccupancyState(
        density_grid=torch.zeros(grid_size * grid_size, device=device),
        mean_density=torch.zeros((), device=device),
    )


@torch.no_grad()
def update_torso_occupancy(
    alpha_fn: Callable,  # xy [M, 2] -> alpha [M]
    occ: TorsoOccupancyState,
    jitter: torch.Tensor,  # [H*H, 2] uniform in [0, 1)
    *,
    grid_size: int,
    decay: float = 0.95,
) -> TorsoOccupancyState:
    """Alpha sweep at the jittered cell centres (x-major order), stored
    transposed as ``[y, x]``, dilated by a 5×5 max-pool, then
    ``max(decay·density, new)`` and the new mean. The jitter arrives as
    ``jitter``."""
    H = grid_size
    half_cell = 1.0 / H
    r = torch.arange(H, dtype=torch.float32, device=occ.density_grid.device)
    gx, gy = torch.meshgrid(r, r, indexing="ij")
    xy = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    xy = (2.0 * xy / (H - 1) - 1.0) * (1.0 - half_cell)
    xy = xy + (jitter * 2 - 1) * half_cell
    tmp = alpha_fn(xy).float().reshape(H, H).T  # [y, x]
    tmp = torch.nn.functional.max_pool2d(tmp[None, None], 5, stride=1, padding=2)[0, 0]
    density = torch.maximum(occ.density_grid * decay, tmp.reshape(-1))
    return TorsoOccupancyState(density, density.mean())


def torso_occupancy_mask(
    torso_occ: TorsoOccupancyState,
    bg_coords: torch.Tensor,  # [N, 2]
    grid_size: int,
    density_thresh_torso: float,
) -> torch.Tensor:
    """[N] bool: the torso grid at each screen coordinate exceeds
    ``min(density_thresh_torso, mean)`` (strictly). Serving computes it
    once per video."""
    thresh = torch.clamp(torso_occ.mean_density, max=density_thresh_torso)
    return sample_torso_occupancy(torso_occ.density_grid, bg_coords, grid_size) > thresh


def render_rays_radnerf_torso(
    field_fn: Callable,  # head field (xyz, dirs) -> (sigma, rgb, ambient)
    torso_fn: Callable,  # (xy [N, 2], head_rgb [N, 3], head_ws [N, 1]) -> (alpha, color, dx)
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    bg_coords: torch.Tensor,  # [N, 2] in [-1, 1]
    occ: OccupancyView,
    torso_occ: TorsoOccupancyState,
    *,
    density_thresh_torso: float,
    bg_color: torch.Tensor | float = 1.0,
    torso_mask: torch.Tensor | None = None,
    **head_kwargs,
) -> dict:
    """The head (``render_rays_radnerf`` with ``head_kwargs``, background 0,
    no gradient) over the torso, the torso over ``bg_color``:
    ``torso_bg = color·α·mask + bg·(1 − α·mask)`` and
    ``image = clip(head_rgb + (1 − head_ws)·torso_bg)``. ``torso_mask`` [N]
    is the per-video :func:`torso_occupancy_mask`; ``None`` samples the
    grid here (training)."""
    grid_size = head_kwargs["grid_size"]
    with torch.no_grad():
        head = render_rays_radnerf(field_fn, rays_o, rays_d, occ, bg_color=0.0, **head_kwargs)
    if torso_mask is None:
        torso_mask = torso_occupancy_mask(torso_occ, bg_coords, grid_size, density_thresh_torso)
    mask = torso_mask.float().reshape(-1, 1)
    with record_function("gf::torso"):
        ws = head["weights_sum"][:, None]
        alpha, color, deform = torso_fn(bg_coords, head["rgb_map"], ws)
        torso_alpha = alpha * mask
        torso_bg = color * mask * torso_alpha + bg_color * (1.0 - torso_alpha)
        image = (head["rgb_map"] + (1.0 - ws) * torso_bg).clamp(0.0, 1.0)
    return {
        "rgb_map": image,
        "depth_map": head["depth_map"],
        "weights_sum": head["weights_sum"],
        "torso_alpha_map": torso_alpha,
        "torso_rgb_map": torso_bg,
        "deform": deform,
        "n_samples": head["n_samples"],
        "march_span": head["march_span"],
    }
