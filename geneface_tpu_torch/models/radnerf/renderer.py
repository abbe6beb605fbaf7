"""Occupancy state, k-DOP ray cull and the compact render path (port of
``geneface_tpu/models/radnerf/renderer.py``, inference side).

A frame runs: the 13-slab k-DOP cull of the full frame; the lattice march of
the kept rays; waterfilled compaction; one ``[Mc, 8]`` record gather; the
field; front-to-back compositing in compact space; and the scatter of the
kept rays back to the frame. The per-ray sums of the composite and the frame
scatter are both row scatter-adds, i.e. the CUDA kernel behind
:func:`geneface_tpu_torch.ops.scatter_add_rows`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from geneface_tpu_torch.ops import (
    compact_gather,
    make_compact_plan,
    march_rays_lattice,
    near_far_from_aabb,
    occupied_cell_aabb,
    pack_occ_blocks,
    scatter_add_rows,
    segmented_cumsum,
    waterfill_valid,
)

__all__ = [
    "OccupancyState",
    "make_aabb",
    "occupied_kdop",
    "kdop_hit",
    "OccupancyView",
    "occupancy_view",
    "render_rays_radnerf",
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


class OccupancyView(NamedTuple):
    """Per-video constants derived from the occupancy grid: the packed 8³
    blocks the march tests and the tight occupied box it fast-forwards to."""

    blocks: torch.Tensor  # [(H/8)^3, 16] int32
    tight: torch.Tensor  # [6]


def occupancy_view(occ_grid: torch.Tensor, bound: float) -> OccupancyView:
    """Pack ``occ_grid [1, H, H, H]`` for :func:`render_rays_radnerf`. The
    lattice march needs a single cascade."""
    if occ_grid.shape[0] != 1:
        raise NotImplementedError("the port marches a single cascade (bound <= 1)")
    return OccupancyView(pack_occ_blocks(occ_grid[0]), occupied_cell_aabb(occ_grid[0], bound))


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
    lattice_K: int,
    mean_samples_per_ray: float,
    bg_color: torch.Tensor | float = 1.0,
    T_thresh: float = 1e-4,
    ray_capacity: int | None = None,
    cull_kdop: tuple | None = None,
) -> dict:
    """Lattice march + compact field eval + composite + background.

    With ``ray_capacity`` (and ``cull_kdop``) only the first
    ``ray_capacity`` rays that meet the k-DOP are rendered; overflow rays
    render as background, as in the JAX renderer. The march is not
    jittered (the inference setting). Returns rgb_map [N, 3], depth_map,
    weights_sum, ambient_sum [N] and ``n_samples`` [rendered rays].
    """
    N = rays_o.shape[0]
    dev = rays_o.device
    common = dict(
        bound=bound, min_near=min_near, max_steps=max_steps, grid_size=grid_size,
        lattice_K=lattice_K, mean_samples_per_ray=mean_samples_per_ray,
        T_thresh=T_thresh,
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
            field_fn, rays_o[safe], rays_d[safe], occ, bg_color=0.0, **common
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
            full = scatter_add_rows(idx.to(torch.int32), packed, N)
            rgb, ws, depth, amb = full[:, 0:3], full[:, 3], full[:, 4], full[:, 5]
            image = (rgb + (1.0 - ws)[:, None] * bg_color).clamp(0.0, 1.0)
        return {
            "rgb_map": image,
            "depth_map": depth,
            "weights_sum": ws,
            "ambient_sum": amb,
            "n_samples": inner["n_samples"],
        }

    with record_function("gf::march"):
        nears, fars = near_far_from_aabb(rays_o, rays_d, make_aabb(bound, dev), min_near)
        march = march_rays_lattice(
            rays_o, rays_d, occ.blocks, occ.tight, nears, fars, torch.zeros(N, device=dev),
            bound=bound, max_steps=max_steps, grid_size=grid_size, lattice_K=lattice_K,
        )
    with record_function("gf::compact"):
        S = march.ts.shape[-1]
        # compact-eval capacity: the sample budget, padded to a multiple of
        # 1024 and never beyond the full slab
        capacity = min(int(-(-N * float(mean_samples_per_ray) // 1024) * 1024), N * S)
        plan = make_compact_plan(waterfill_valid(march.valid, capacity), capacity)
        # ONE [Mc, 8] record gather for everything per sample
        ro = rays_o.float()[:, None, :]
        rd = rays_d.float()[:, None, :]
        xyz_slab = ro + march.ts[..., None] * rd  # [N, S, 3]
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
        sums = scatter_add_rows(rows, cols, N)  # [N, 6]
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
    }
