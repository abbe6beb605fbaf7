"""Fused multi-resolution grid encoder, forward (port of
``geneface_tpu/ops/fused_grid.py``).

The parameter layout is the JAX package's: level 0 (and, with
``ungroup_coarse``, the next few levels) is a dense canonical table
``[side^D, C]``; the remaining levels are fused into groups whose rows hold
the ``K = 2^D`` corner features of every level of the group (``[R_g, G*K*C]``),
keyed by the prime-xor hash of the group's finest level's block.

The function is computed directly: gather one row per (sample, group), weight
each level's ``K`` corners by its own interpolation weights, and sum over
corners. The TPU's selector-matmul lane layout is not needed here. Inputs
outside [0, 1] give zeros. Forward only: training (and the grid backward)
is not part of this slice.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from geneface_tpu_torch.ops.encoders import HASH_PRIMES, GridMeta

__all__ = ["FusedGridMeta", "make_fused_grid_meta", "dense_view", "fused_grid_encode"]

_U32 = 0xFFFFFFFF


class FusedGridMeta(NamedTuple):
    base: GridMeta
    groups: tuple  # level-index tuples, e.g. ((0,), (1, ..., 7))
    modes: tuple  # per group: "dense" | "hash"
    n_rows: tuple  # rows of each group's (fast-view) table
    dense_sides: tuple  # per group: entries per axis of the dense level (0 if hash)
    dense_bsides: tuple  # per group: blocks per axis (0 if hash)

    @property
    def input_dim(self):
        return self.base.input_dim

    @property
    def level_dim(self):
        return self.base.level_dim

    @property
    def num_levels(self):
        return self.base.num_levels

    def group_width(self, g: int) -> int:
        return len(self.groups[g]) * (1 << self.input_dim) * self.level_dim


def _level_scale(meta: GridMeta, lvl: int) -> float:
    return math.exp2(lvl * math.log2(meta.per_level_scale)) * meta.base_resolution - 1.0


def make_fused_grid_meta(
    meta: GridMeta,
    single_table: bool = False,
    row_lanes: int = 256,
    ungroup_coarse: int = 0,
    coarse_run: int = 1,
) -> FusedGridMeta:
    """Default grouping: level 0 alone, then ``ungroup_coarse`` levels in
    runs of ``coarse_run``, then the rest in runs of ``row_lanes // (K*C)``
    levels. The grouping fixes the checkpoint's table shapes."""
    D = meta.input_dim
    K = 1 << D
    C = meta.level_dim
    if single_table:
        groups = (tuple(range(meta.num_levels)),)
    else:
        per_row = max(1, int(row_lanes) // (K * C))
        u = max(0, min(int(ungroup_coarse), meta.num_levels - 1))
        run = max(1, int(coarse_run))
        lvls = list(range(1, 1 + u))
        singles = tuple(tuple(lvls[i : i + run]) for i in range(0, len(lvls), run))
        rest = list(range(1 + u, meta.num_levels))
        groups = ((0,),) + singles + tuple(
            tuple(rest[i : i + per_row]) for i in range(0, len(rest), per_row)
        )
    modes, n_rows, sides, bsides = [], [], [], []
    for g in groups:
        hashmap_size = meta.offsets[g[0] + 1] - meta.offsets[g[0]]
        resolution = int(math.ceil(_level_scale(meta, g[0]))) + 1
        side = resolution if meta.align_corners else resolution + 1
        if len(g) == 1 and side**D <= hashmap_size:
            modes.append("dense")
            sides.append(side)
            bsides.append(side // 2 + 1)
            n_rows.append(K * (side // 2 + 1) ** D)
        else:
            modes.append("hash")
            sides.append(0)
            bsides.append(0)
            # the group's parameter count equals its levels' canonical budgets
            total = sum(meta.offsets[l + 1] - meta.offsets[l] for l in g)
            n_rows.append(max(total // (len(g) * K), 1))
    return FusedGridMeta(
        base=meta,
        groups=tuple(tuple(g) for g in groups),
        modes=tuple(modes),
        n_rows=tuple(n_rows),
        dense_sides=tuple(sides),
        dense_bsides=tuple(bsides),
    )


def table_shape(fmeta: FusedGridMeta, gi: int) -> tuple:
    """Parameter shape of group ``gi`` (canonical for dense groups)."""
    if fmeta.modes[gi] == "dense":
        return (fmeta.dense_sides[gi] ** fmeta.input_dim, fmeta.level_dim)
    return (fmeta.n_rows[gi], fmeta.group_width(gi))


def dense_view(table: torch.Tensor, fmeta: FusedGridMeta, gi: int) -> torch.Tensor:
    """Canonical dense ``[side^D, C]`` → parity-copied view
    ``[K*bside^D, K*C]``: row ``parity*bside^D + block`` holds the ``K``
    corner entries of every cell whose base has that parity. A per-checkpoint
    constant: the renderer builds it once per video."""
    D = fmeta.input_dim
    K = 1 << D
    C = fmeta.level_dim
    side = fmeta.dense_sides[gi]
    bside = fmeta.dense_bsides[gi]
    dense = table.reshape((side,) * D + (C,))
    # channels-first for F.pad: pad 1 before / 2 after on every spatial axis
    dense_p = F.pad(dense.movedim(-1, 0), (1, 2) * D).movedim(0, -1)
    copies = []
    for parity in range(K):
        for corner in range(K):
            starts = [
                1 - ((parity >> (D - 1 - a)) & 1) + ((corner >> (D - 1 - a)) & 1)
                for a in range(D)
            ]
            sl = dense_p[tuple(slice(s, s + 2 * bside - 1, 2) for s in starts)]
            copies.append(sl.reshape(-1, C))
    percorner = torch.stack(copies, 0).reshape(K, K, -1, C)
    return percorner.permute(0, 2, 1, 3).reshape(-1, K * C).contiguous()


def _fracs(comps, meta: GridMeta, lvl: int):
    """Per-axis integer base cell and interpolation fraction of one level."""
    scale = _level_scale(meta, lvl)
    off = 0.0 if meta.align_corners else 0.5
    base, frac = [], []
    for c in comps:
        pos = c * scale + off
        pf = torch.floor(pos)
        f = pos - pf
        if meta.interpolation == "smoothstep":
            f = f * f * (3.0 - 2.0 * f)
        base.append(pf.to(torch.int64))
        frac.append(f)
    return base, frac


def _group_rows(comps, fmeta: FusedGridMeta, gi: int) -> torch.Tensor:
    """Row of group ``gi`` per sample: parity-block address for dense
    groups; for hash groups the prime-xor hash (wrapping uint32, computed in
    int64 and masked) of the finest level's block coords and parity."""
    meta = fmeta.base
    D = meta.input_dim
    lvl = fmeta.groups[gi][-1] if fmeta.modes[gi] == "hash" else fmeta.groups[gi][0]
    base, _ = _fracs(comps, meta, lvl)
    pbits = [b & 1 for b in base]
    bcoords = [(b + p) >> 1 for b, p in zip(base, pbits)]
    parity = pbits[0]
    for d in range(1, D):
        parity = parity + (pbits[d] << d)
    if fmeta.modes[gi] == "dense":
        bside = fmeta.dense_bsides[gi]
        blk, stride = bcoords[0], bside
        for d in range(1, D):
            blk = blk + bcoords[d] * stride
            stride *= bside
        return parity * (bside**D) + blk
    h = (bcoords[0] * HASH_PRIMES[0]) & _U32
    for d in range(1, D):
        h = h ^ ((bcoords[d] * HASH_PRIMES[d]) & _U32)
    h = h ^ ((parity * HASH_PRIMES[min(D, 6)]) & _U32)
    return h % fmeta.n_rows[gi]


def fused_grid_encode(
    inputs: torch.Tensor | tuple,
    tables: list,
    fmeta: FusedGridMeta,
) -> torch.Tensor:
    """Grouped multi-resolution interpolation → ``[..., L*C]`` float32.

    ``inputs``: ``[..., D]`` in [0, 1], or a tuple of ``D`` coordinate
    columns. ``tables[gi]``: the group's fast-view table — :func:`dense_view`
    of the canonical table for dense groups, the parameter itself for hash
    groups.
    """
    meta = fmeta.base
    D, C = meta.input_dim, meta.level_dim
    K = 1 << D
    if isinstance(inputs, (tuple, list)):
        prefix = inputs[0].shape
        comps_raw = [c.reshape(-1).float() for c in inputs]
    else:
        prefix = inputs.shape[:-1]
        x = inputs.reshape(-1, D).float()
        comps_raw = [x[:, d] for d in range(D)]
    oob = torch.zeros_like(comps_raw[0], dtype=torch.bool)
    for c in comps_raw:
        oob = oob | (c < 0.0) | (c > 1.0)
    comps = [c.clamp(0.0, 1.0) for c in comps_raw]
    M = comps[0].shape[0]
    bits = torch.arange(K, device=comps[0].device)

    outs = []
    for gi, g in enumerate(fmeta.groups):
        G = len(g)
        rows = tables[gi].float()[_group_rows(comps, fmeta, gi)]
        rows = rows.reshape(M, G, K, C)
        fr = [torch.stack(_fracs(comps, meta, lvl)[1], dim=-1) for lvl in g]
        fr = torch.stack(fr, dim=1)  # [M, G, D]
        w = None
        for d in range(D):
            fd = fr[:, :, d : d + 1]  # [M, G, 1]
            wd = torch.where(((bits >> d) & 1) == 1, fd, 1.0 - fd)  # [M, G, K]
            w = wd if w is None else w * wd
        outs.append((w[..., None] * rows).sum(dim=2).reshape(M, G * C))
    out = torch.cat(outs, dim=-1)
    out = torch.where(oob[:, None], 0.0, out)
    return out.reshape(*prefix, meta.num_levels * C)
