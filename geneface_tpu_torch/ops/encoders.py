"""Frequency and SH encodings and the multi-resolution grid encoders of the
``reference`` and ``block`` backends (port of ``geneface_tpu/ops/encoders.py``;
the ``fused`` backend is :mod:`geneface_tpu_torch.ops.fused_grid`).

Both backends read the canonical ``[n_entries, C]`` table of the reference
CUDA ``gridencoder``: a GeneFace checkpoint's embeddings run unchanged under
either.

- ``reference`` (:func:`grid_encode`): the exact ``gridencoder.cu`` addressing
  — dense strides while ``stride <= hashmap_size``, then the prime-xor hash
  for ``hash`` grids, ``% hashmap_size`` — computed per level for all ``2^D``
  corners at once, whose ``[2^D · M, C]`` rows come from one row gather (K8,
  :func:`~geneface_tpu_torch.ops.scatter.gather_rows`, whose backward is the
  K1 row scatter-add into the level's table). The corner-weighted sum is
  plain torch, so autograd also gives the input gradient.
- ``block`` (:func:`fast_grid_encode`): the canonical table is rebuilt as a
  per-level fast table whose row holds the ``2^D`` corners of one cell
  (:func:`build_block_tables`, bfloat16 as in the JAX package), read with one
  wide K8 row gather per level; its backward scatters each level's gradient
  with one K1 launch into that level's local table and maps the fast-table
  gradient back to the canonical parameters through the adjoint of
  :func:`build_block_tables`.

The uint32 arithmetic of the hash (coordinates times primes up to
3,674,653,429, wrapping at 2³²) runs in int64 masked to 32 bits after each
product. Inputs outside [0, 1] give zeros and zero gradients.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from geneface_tpu_torch.ops.scatter import gather_rows, launch_gather_rows, launch_scatter_add_rows

__all__ = [
    "freq_encode",
    "freq_encode_output_dim",
    "sh_encode",
    "GridMeta",
    "make_grid_meta",
    "HASH_PRIMES",
    "init_grid_embeddings",
    "grid_encode",
    "BlockGridMeta",
    "make_block_grid_meta",
    "build_block_tables",
    "block_grid_encode",
    "fast_grid_encode",
    "parity_copies",
]

_U32 = 0xFFFFFFFF

#: prime-xor hash constants of the reference grid encoder
HASH_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)


def freq_encode(x: torch.Tensor, degree: int) -> torch.Tensor:
    """NeRF positional encoding ``[x, sin(2^0 x), cos(2^0 x), sin(2^1 x),
    ...]``: the ``D`` input columns, then per frequency a ``sin`` block and
    a ``cos`` block of ``D`` columns each."""
    cols = [x]
    for f in range(degree):
        scaled = x * (2.0**f)
        cols.append(torch.sin(scaled))
        cols.append(torch.cos(scaled))
    return torch.cat(cols, dim=-1)


def freq_encode_output_dim(input_dim: int, degree: int) -> int:
    return input_dim * (1 + 2 * degree)


def sh_encode(d: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Real spherical harmonics of ``degree`` ∈ [1, 8] on unit directions
    ``d [..., 3]`` (instant-ngp sign convention, the coefficients of
    ``shencoder.cu``) → ``[..., degree²]``. The model uses degree 4."""
    if not 1 <= degree <= 8:
        raise ValueError(f"sh degree must be in [1, 8], got {degree}")
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    if degree >= 5:
        x4, y4, z4 = x2 * x2, y2 * y2, z2 * z2
        x6, y6, z6 = x4 * x2, y4 * y2, z4 * z2
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 2:
        out += [
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
        ]
    if degree >= 3:
        out += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * z2 - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * x2 - 0.54627421529603959 * y2,
        ]
    if degree >= 4:
        out += [
            0.59004358992664352 * y * (-3.0 * x2 + y2),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * z2),
            0.3731763325901154 * z * (5.0 * z2 - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * z2),
            1.4453057213202769 * z * (x2 - y2),
            0.59004358992664352 * x * (-x2 + 3.0 * y2),
        ]
    if degree >= 5:
        out += [
            2.5033429417967046 * xy * (x2 - y2),
            1.7701307697799304 * yz * (-3.0 * x2 + y2),
            0.94617469575756008 * xy * (7.0 * z2 - 1.0),
            0.66904654355728921 * yz * (3.0 - 7.0 * z2),
            -3.1735664074561294 * z2 + 3.7024941420321507 * z4 + 0.31735664074561293,
            0.66904654355728921 * xz * (3.0 - 7.0 * z2),
            0.47308734787878004 * (x2 - y2) * (7.0 * z2 - 1.0),
            1.7701307697799304 * xz * (-x2 + 3.0 * y2),
            -3.7550144126950569 * x2 * y2 + 0.62583573544917614 * x4
            + 0.62583573544917614 * y4,
        ]
    if degree >= 6:
        out += [
            0.65638205684017015 * y * (10.0 * x2 * y2 - 5.0 * x4 - y4),
            8.3026492595241645 * xy * z * (x2 - y2),
            -0.48923829943525038 * y * (3.0 * x2 - y2) * (9.0 * z2 - 1.0),
            4.7935367849733241 * xy * z * (3.0 * z2 - 1.0),
            0.45294665119569694 * y * (14.0 * z2 - 21.0 * z4 - 1.0),
            0.1169503224534236 * z * (-70.0 * z2 + 63.0 * z4 + 15.0),
            0.45294665119569694 * x * (14.0 * z2 - 21.0 * z4 - 1.0),
            2.3967683924866621 * z * (x2 - y2) * (3.0 * z2 - 1.0),
            -0.48923829943525038 * x * (x2 - 3.0 * y2) * (9.0 * z2 - 1.0),
            2.0756623148810411 * z * (-6.0 * x2 * y2 + x4 + y4),
            0.65638205684017015 * x * (10.0 * x2 * y2 - x4 - 5.0 * y4),
        ]
    if degree >= 7:
        out += [
            1.3663682103838286 * xy * (-10.0 * x2 * y2 + 3.0 * x4 + 3.0 * y4),
            2.3666191622317521 * yz * (10.0 * x2 * y2 - 5.0 * x4 - y4),
            2.0182596029148963 * xy * (x2 - y2) * (11.0 * z2 - 1.0),
            -0.92120525951492349 * yz * (3.0 * x2 - y2) * (11.0 * z2 - 3.0),
            0.92120525951492349 * xy * (-18.0 * z2 + 33.0 * z4 + 1.0),
            0.58262136251873131 * yz * (30.0 * z2 - 33.0 * z4 - 5.0),
            6.6747662381009842 * z2 - 20.024298714302954 * z4
            + 14.684485723822165 * z6 - 0.31784601133814211,
            0.58262136251873131 * xz * (30.0 * z2 - 33.0 * z4 - 5.0),
            0.46060262975746175 * (x2 - y2)
            * (11.0 * z2 * (3.0 * z2 - 1.0) - 7.0 * z2 + 1.0),
            -0.92120525951492349 * xz * (x2 - 3.0 * y2) * (11.0 * z2 - 3.0),
            0.50456490072872406 * (11.0 * z2 - 1.0) * (-6.0 * x2 * y2 + x4 + y4),
            2.3666191622317521 * xz * (10.0 * x2 * y2 - x4 - 5.0 * y4),
            10.247761577878714 * x2 * y4 - 10.247761577878714 * x4 * y2
            + 0.6831841051919143 * x6 - 0.6831841051919143 * y6,
        ]
    if degree >= 8:
        out += [
            0.70716273252459627 * y * (-21.0 * x2 * y4 + 35.0 * x4 * y2 - 7.0 * x6 + y6),
            5.2919213236038001 * xy * z * (-10.0 * x2 * y2 + 3.0 * x4 + 3.0 * y4),
            -0.51891557872026028 * y * (13.0 * z2 - 1.0)
            * (-10.0 * x2 * y2 + 5.0 * x4 + y4),
            4.1513246297620823 * xy * z * (x2 - y2) * (13.0 * z2 - 3.0),
            -0.15645893386229404 * y * (3.0 * x2 - y2)
            * (13.0 * z2 * (11.0 * z2 - 3.0) - 27.0 * z2 + 3.0),
            0.44253269244498261 * xy * z * (-110.0 * z2 + 143.0 * z4 + 15.0),
            0.090331607582517306 * y * (-135.0 * z2 + 495.0 * z4 - 429.0 * z6 + 5.0),
            0.068284276912004949 * z * (315.0 * z2 - 693.0 * z4 + 429.0 * z6 - 35.0),
            0.090331607582517306 * x * (-135.0 * z2 + 495.0 * z4 - 429.0 * z6 + 5.0),
            0.07375544874083044 * z * (x2 - y2)
            * (143.0 * z2 * (3.0 * z2 - 1.0) - 187.0 * z2 + 45.0),
            -0.15645893386229404 * x * (x2 - 3.0 * y2)
            * (13.0 * z2 * (11.0 * z2 - 3.0) - 27.0 * z2 + 3.0),
            1.0378311574405206 * z * (13.0 * z2 - 3.0) * (-6.0 * x2 * y2 + x4 + y4),
            -0.51891557872026028 * x * (13.0 * z2 - 1.0)
            * (-10.0 * x2 * y2 + x4 + 5.0 * y4),
            2.6459606618019 * z * (15.0 * x2 * y4 - 15.0 * x4 * y2 + x6 - y6),
            0.70716273252459627 * x * (-35.0 * x2 * y4 + 21.0 * x4 * y2 - x6 + 7.0 * y6),
        ]
    return torch.stack(out, dim=-1)


class GridMeta(NamedTuple):
    """Static metadata for a multi-resolution grid encoder."""

    input_dim: int
    num_levels: int
    level_dim: int
    base_resolution: int
    per_level_scale: float
    offsets: tuple  # [L+1] starts of each level in the canonical table
    gridtype: str  # "hash" | "tiled"
    align_corners: bool
    interpolation: str  # "linear" | "smoothstep"

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    @property
    def n_entries(self) -> int:
        return self.offsets[-1]


def make_grid_meta(
    input_dim: int = 3,
    num_levels: int = 16,
    level_dim: int = 2,
    base_resolution: int = 16,
    log2_hashmap_size: int = 19,
    desired_resolution: int | None = None,
    per_level_scale: float = 2.0,
    gridtype: str = "hash",
    align_corners: bool = False,
    interpolation: str = "linear",
) -> GridMeta:
    """Level layout of the reference encoder: per-level entry count is
    ``min(2^log2_hashmap_size, side^D)`` rounded up to a multiple of 8."""
    if desired_resolution is not None:
        per_level_scale = float(
            np.exp2(np.log2(desired_resolution / base_resolution) / max(num_levels - 1, 1))
        )
    max_params = 2**log2_hashmap_size
    offsets = [0]
    for lvl in range(num_levels):
        res = int(np.ceil(base_resolution * per_level_scale**lvl))
        side = res if align_corners else res + 1
        n = min(max_params, side**input_dim)
        n = int(np.ceil(n / 8) * 8)
        offsets.append(offsets[-1] + n)
    return GridMeta(
        input_dim=input_dim,
        num_levels=num_levels,
        level_dim=level_dim,
        base_resolution=base_resolution,
        per_level_scale=per_level_scale,
        offsets=tuple(offsets),
        gridtype=gridtype,
        align_corners=align_corners,
        interpolation=interpolation,
    )


# ------------------------------------------------------------ reference ----
def level_scale(meta: GridMeta, lvl: int) -> float:
    """``2^(lvl·log2 s)·base − 1``: the level's input scale."""
    return math.exp2(lvl * math.log2(meta.per_level_scale)) * meta.base_resolution - 1.0


def init_grid_embeddings(generator: torch.Generator, meta: GridMeta,
                         std: float = 1e-4) -> torch.Tensor:
    """Canonical table ``[n_entries, C]``, uniform in (−std, std) (the
    reference's init)."""
    u = torch.rand(meta.n_entries, meta.level_dim, generator=generator)
    return (u * 2.0 - 1.0) * std


def _corner_bits(D: int, device) -> torch.Tensor:
    """``[2^D, D]`` int64: bit ``d`` of corner ``k``."""
    k = torch.arange(1 << D, device=device)
    return torch.stack([(k >> d) & 1 for d in range(D)], dim=1)


def _corner_index_1d(comps: list, meta: GridMeta, resolution: int,
                     hashmap_size: int) -> torch.Tensor:
    """Per-level entry index of integer corner coordinates (``D`` int64
    tensors of one shape): ``get_grid_index`` of ``gridencoder.cu:67-84`` in
    uint32 arithmetic, carried in int64."""
    D = meta.input_dim
    side = resolution if meta.align_corners else resolution + 1
    stride = 1
    index = torch.zeros_like(comps[0])
    for d in range(D):
        if stride > hashmap_size:
            break
        index = (index + comps[d] * stride) & _U32
        stride *= side
    if meta.gridtype == "hash" and stride > hashmap_size:
        index = (comps[0] * HASH_PRIMES[0]) & _U32
        for d in range(1, D):
            index = index ^ ((comps[d] * HASH_PRIMES[d]) & _U32)
    return index % hashmap_size


def _level_base_frac(comps: list, meta: GridMeta, lvl: int) -> tuple:
    """Per axis: the integer base cell (int64) and the interpolation
    fraction (smoothstepped when the meta says so) of one level."""
    scale = level_scale(meta, lvl)
    off = 0.0 if meta.align_corners else 0.5
    base, frac = [], []
    for c in comps:
        pos = c * scale + off
        pf = torch.floor(pos)
        f = pos - pf
        if meta.interpolation == "smoothstep":
            f = f * f * (3.0 - 2.0 * f)
        base.append(pf.detach().to(torch.int64))
        frac.append(f)
    return base, frac


def _split_inputs(inputs, D: int) -> tuple:
    """``[..., D]`` or a tuple of ``D`` columns → (prefix shape, ``D`` float32
    columns ``[M]``, out-of-range mask ``[M]``, the columns clipped to [0, 1])."""
    if isinstance(inputs, (tuple, list)):
        prefix = inputs[0].shape
        cols = [c.reshape(-1).float() for c in inputs]
    else:
        prefix = inputs.shape[:-1]
        x = inputs.reshape(-1, D).float()
        cols = [x[:, d] for d in range(D)]
    oob = torch.zeros_like(cols[0], dtype=torch.bool)
    for c in cols:
        oob = oob | (c < 0.0) | (c > 1.0)
    return prefix, cols, oob, [c.clamp(0.0, 1.0) for c in cols]


def grid_encode(inputs, embeddings: torch.Tensor, meta: GridMeta) -> torch.Tensor:
    """Multi-resolution interpolation with the reference's exact addressing
    → ``[..., L*C]`` float32.

    ``inputs``: ``[..., D]`` in [0, 1] or a tuple of ``D`` columns;
    ``embeddings``: the canonical ``[n_entries, C]`` table. Per level the
    ``2^D`` corners' rows (corner-major, ``[2^D·M]`` indices into the level's
    table) come from one K8 row gather; autograd gives the table gradient
    (one K1 scatter per level) and the input gradient."""
    D, C = meta.input_dim, meta.level_dim
    K = 1 << D
    prefix, _, oob, comps = _split_inputs(inputs, D)
    M = comps[0].shape[0]
    bits = _corner_bits(D, comps[0].device)
    outs = []
    for lvl in range(meta.num_levels):
        scale = level_scale(meta, lvl)
        resolution = int(math.ceil(scale)) + 1
        hashmap_size = meta.offsets[lvl + 1] - meta.offsets[lvl]
        base, frac = _level_base_frac(comps, meta, lvl)
        local = [base[d][None, :] + bits[:, d, None] for d in range(D)]  # D x [K, M]
        rows = _corner_index_1d(local, meta, resolution, hashmap_size)
        w = None
        for d in range(D):
            wd = torch.where(bits[:, d, None] == 1, frac[d][None, :], 1.0 - frac[d][None, :])
            w = wd if w is None else w * wd  # [K, M]
        table = embeddings[meta.offsets[lvl] : meta.offsets[lvl + 1]]
        site = (meta, lvl, "reference")
        v = gather_rows(table, rows.reshape(-1).to(torch.int32), site).reshape(K, M, C)
        acc = w[0, :, None] * v[0]
        for k in range(1, K):
            acc = acc + w[k, :, None] * v[k]
        outs.append(acc)
    out = torch.where(oob[:, None], 0.0, torch.cat(outs, dim=-1))
    return out.reshape(*prefix, meta.num_levels * C)


# ---------------------------------------------------------------- block ----
class BlockGridMeta(NamedTuple):
    """Static metadata of the block-row layout: per level ``dense`` (the
    level fits its hashmap budget: the fast table holds, for each base
    parity, the parity-shifted copy of the canonical table, so the
    interpolation is the reference's) or ``block_hash`` (capped: the
    canonical region read as ``[hashmap_size / 2^D, 2^D·C]`` rows addressed
    by a prime-xor hash of the cell's block and parity — equal capacity,
    aliasing at block granularity, which the reference does not do)."""

    base: GridMeta
    modes: tuple  # per level: "dense" | "block_hash"
    level_sides: tuple  # entries per axis of each level
    block_sides: tuple  # blocks per axis (dense levels, else 0)
    row_offsets: tuple  # start row of each level in the fast table
    n_hash_rows: tuple  # rows of block_hash levels (hashmap // 2^D, else 0)

    @property
    def input_dim(self):
        return self.base.input_dim

    @property
    def num_levels(self):
        return self.base.num_levels

    @property
    def level_dim(self):
        return self.base.level_dim

    @property
    def output_dim(self):
        return self.base.output_dim

    @property
    def row_width(self):
        return (1 << self.input_dim) * self.level_dim

    @property
    def total_rows(self):
        return self.row_offsets[-1]

    def level_rows(self, lvl: int) -> int:
        return self.row_offsets[lvl + 1] - self.row_offsets[lvl]


def make_block_grid_meta(meta: GridMeta) -> BlockGridMeta:
    D = meta.input_dim
    K = 1 << D
    modes, sides, bsides, offs, nrows = [], [], [], [0], []
    for lvl in range(meta.num_levels):
        resolution = int(math.ceil(level_scale(meta, lvl))) + 1
        side = resolution if meta.align_corners else resolution + 1
        hashmap_size = meta.offsets[lvl + 1] - meta.offsets[lvl]
        sides.append(side)
        if side**D <= hashmap_size:
            modes.append("dense")
            bside = side // 2 + 1
            bsides.append(bside)
            nrows.append(0)
            offs.append(offs[-1] + K * bside**D)
        else:
            modes.append("block_hash")
            bsides.append(0)
            n = max(hashmap_size // K, 1)
            nrows.append(n)
            offs.append(offs[-1] + n)
    return BlockGridMeta(meta, tuple(modes), tuple(sides), tuple(bsides), tuple(offs),
                         tuple(nrows))


def _parity_starts(D: int, parity: int, corner: int) -> list:
    """Start of each axis (axis ``a`` holds dim ``D−1−a``) of the strided
    slice of the padded dense table that holds corner ``corner`` of the
    cells whose base has parity ``parity``."""
    return [1 - ((parity >> (D - 1 - a)) & 1) + ((corner >> (D - 1 - a)) & 1)
            for a in range(D)]


def parity_copies(dense_flat: torch.Tensor, side: int, bside: int, D: int) -> torch.Tensor:
    """Canonical dense ``[side^D, C]`` (dim 0 fastest) → parity-copied rows
    ``[K·bside^D, K·C]``: row ``parity·bside^D + block`` holds the ``K``
    corner entries of the cell with that base parity in that block
    (strided slices, no gathers)."""
    K = 1 << D
    C = dense_flat.shape[-1]
    dense = dense_flat.reshape((side,) * D + (C,))
    # channels-first for F.pad: pad 1 before / 2 after on every spatial axis
    dense_p = F.pad(dense.movedim(-1, 0), (1, 2) * D).movedim(0, -1)
    copies = []
    for parity in range(K):
        for corner in range(K):
            starts = _parity_starts(D, parity, corner)
            sl = dense_p[tuple(slice(s, s + 2 * bside - 1, 2) for s in starts)]
            copies.append(sl.reshape(-1, C))
    percorner = torch.stack(copies, 0).reshape(K, K, -1, C)
    return percorner.permute(0, 2, 1, 3).reshape(-1, K * C)


def _parity_copies_adjoint(g_rows: torch.Tensor, side: int, bside: int, D: int) -> torch.Tensor:
    """Adjoint of :func:`parity_copies`: ``[K·bside^D, K·C]`` → ``[side^D, C]``."""
    K = 1 << D
    C = g_rows.shape[-1] // K
    g = g_rows.reshape(K, -1, K, C)  # [parity, block, corner, C]
    g_p = torch.zeros((side + 3,) * D + (C,), dtype=g_rows.dtype, device=g_rows.device)
    for parity in range(K):
        for corner in range(K):
            starts = _parity_starts(D, parity, corner)
            view = g_p[tuple(slice(s, s + 2 * bside - 1, 2) for s in starts)]
            view += g[parity, :, corner].reshape(view.shape)
    return g_p[(slice(1, 1 + side),) * D].reshape(-1, C)


def _level_tables(embeddings: torch.Tensor, bmeta: BlockGridMeta, dtype) -> list:
    """Per level the fast table ``[level_rows, K·C]`` in ``dtype``."""
    meta = bmeta.base
    D = meta.input_dim
    K = 1 << D
    C = meta.level_dim
    parts = []
    for lvl in range(meta.num_levels):
        region = embeddings[meta.offsets[lvl] : meta.offsets[lvl + 1]]
        if bmeta.modes[lvl] == "block_hash":
            n = bmeta.n_hash_rows[lvl]
            parts.append(region[: n * K].reshape(n, K * C).to(dtype))
        else:
            side = bmeta.level_sides[lvl]
            parts.append(parity_copies(region[: side**D], side, bmeta.block_sides[lvl], D)
                         .to(dtype))
    return parts


def build_block_tables(embeddings: torch.Tensor, bmeta: BlockGridMeta,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """Canonical ``[n_entries, C]`` → fast table ``[total_rows, 2^D·C]``
    (dense levels: parity copies; block-hash levels: a reshape of the
    canonical region). Differentiable."""
    return torch.cat(_level_tables(embeddings, bmeta, dtype), dim=0)


def _block_tables_adjoint(g_parts: list, bmeta: BlockGridMeta) -> torch.Tensor:
    """Adjoint of :func:`build_block_tables` (float32): per-level fast-table
    gradients → the canonical ``[n_entries, C]`` gradient."""
    meta = bmeta.base
    D = meta.input_dim
    K = 1 << D
    C = meta.level_dim
    dev = g_parts[0].device
    g = torch.zeros(meta.n_entries, C, dtype=torch.float32, device=dev)
    for lvl, gl in enumerate(g_parts):
        o = meta.offsets[lvl]
        if bmeta.modes[lvl] == "block_hash":
            n = bmeta.n_hash_rows[lvl]
            g[o : o + n * K] = gl.reshape(n * K, C)
        else:
            side = bmeta.level_sides[lvl]
            g[o : o + side**D] = _parity_copies_adjoint(gl, side, bmeta.block_sides[lvl], D)
    return g


def _block_level_rows(comps: list, bmeta: BlockGridMeta, lvl: int) -> tuple:
    """(per-axis fraction, int32 row of the level's local fast table) of
    the clipped inputs ``comps`` at level ``lvl``."""
    meta = bmeta.base
    D = meta.input_dim
    base, frac = _level_base_frac(comps, meta, lvl)
    pbits = [b & 1 for b in base]
    bcoords = [(b + p) >> 1 for b, p in zip(base, pbits)]
    parity = pbits[0]
    for d in range(1, D):
        parity = parity + (pbits[d] << d)
    if bmeta.modes[lvl] == "dense":
        bside = bmeta.block_sides[lvl]
        blk, stride = bcoords[0], bside
        for d in range(1, D):
            blk = blk + bcoords[d] * stride
            stride *= bside
        row = parity * (bside**D) + blk
    else:
        h = (bcoords[0] * HASH_PRIMES[0]) & _U32
        for d in range(1, D):
            h = h ^ ((bcoords[d] * HASH_PRIMES[d]) & _U32)
        h = h ^ ((parity * HASH_PRIMES[min(D, 6)]) & _U32)
        row = h % bmeta.n_hash_rows[lvl]
    return frac, row.to(torch.int32)


def _corner_weights(frac: list, K: int) -> torch.Tensor:
    """``[M, K]`` interpolation weights: corner bit ``d`` picks ``frac_d``
    over ``1 − frac_d``."""
    bits = _corner_bits(len(frac), frac[0].device)
    w = None
    for d, fd in enumerate(frac):
        wd = torch.where(bits[None, :, d] == 1, fd[:, None], 1.0 - fd[:, None])
        w = wd if w is None else w * wd
    return w


def block_grid_encode(inputs, block_tables: torch.Tensor, bmeta: BlockGridMeta) -> torch.Tensor:
    """The block layout's interpolation from a built fast table, in plain
    torch indexing (differentiable in the table and the inputs) →
    ``[..., L*C]``: the reference for :func:`fast_grid_encode`."""
    meta = bmeta.base
    D, C = meta.input_dim, meta.level_dim
    K = 1 << D
    prefix, _, oob, comps = _split_inputs(inputs, D)
    outs = []
    for lvl in range(meta.num_levels):
        frac, row = _block_level_rows(comps, bmeta, lvl)
        rows = block_tables[bmeta.row_offsets[lvl] + row.long()].float().reshape(-1, K, C)
        outs.append((_corner_weights(frac, K)[:, :, None] * rows).sum(dim=1))
    out = torch.where(oob[:, None], 0.0, torch.cat(outs, dim=-1))
    return out.reshape(*prefix, meta.num_levels * C)


class _FastGridEncode(torch.autograd.Function):
    """Forward: the fast tables (bfloat16), then one K8 row gather per level
    into its local table. Backward (``_fge_bwd`` of the JAX package): one K1
    scatter per level into its local table, the input gradient in closed
    form from the rows gathered in the forward, and the fast-table gradient
    mapped to the canonical table by the adjoint of the build."""

    @staticmethod
    def forward(ctx, bmeta, embeddings, *cols):
        meta = bmeta.base
        D, C = meta.input_dim, meta.level_dim
        K = 1 << D
        oob = torch.zeros_like(cols[0], dtype=torch.bool)
        for c in cols:
            oob = oob | (c < 0.0) | (c > 1.0)
        comps = [c.clamp(0.0, 1.0) for c in cols]
        input_grad = any(ctx.needs_input_grad[2:])
        tables = _level_tables(embeddings, bmeta, torch.bfloat16)
        outs, rows_idx, rows_saved = [], [], []
        for lvl in range(meta.num_levels):
            frac, row = _block_level_rows(comps, bmeta, lvl)
            site = (bmeta, lvl, "block")  # noqa: F841 (names the launch for measurements)
            rows = launch_gather_rows(tables[lvl], row)  # [M, K*C] float32
            rows3 = rows.reshape(-1, K, C)
            outs.append((_corner_weights(frac, K)[:, :, None] * rows3).sum(dim=1))
            rows_idx.append(row)
            if input_grad:
                rows_saved.append(rows3)
        ctx.bmeta = bmeta
        ctx.input_grad = input_grad
        ctx.emb_dtype = embeddings.dtype
        ctx.save_for_backward(oob, *comps, *rows_idx, *rows_saved)
        return torch.where(oob[:, None], 0.0, torch.cat(outs, dim=-1))

    @staticmethod
    def backward(ctx, gout):
        with record_function("gf::grid_backward"):
            bmeta = ctx.bmeta
            meta = bmeta.base
            D, C, L = meta.input_dim, meta.level_dim, meta.num_levels
            K = 1 << D
            saved = ctx.saved_tensors
            oob, comps = saved[0], list(saved[1 : 1 + D])
            rows_idx = saved[1 + D : 1 + D + L]
            rows_saved = saved[1 + D + L :]
            g2 = torch.where(oob[:, None], 0.0, gout.float())
            bits = _corner_bits(D, g2.device)
            grad_comps = [torch.zeros_like(comps[0]) for _ in range(D)] if ctx.input_grad else None
            g_parts = []
            for lvl in range(L):
                g_lvl = g2[:, lvl * C : (lvl + 1) * C]  # [M, C]
                frac = _level_base_frac(comps, meta, lvl)[1]
                w = _corner_weights(frac, K)  # [M, K]
                if ctx.needs_input_grad[1]:
                    site = (bmeta, lvl, "block")  # noqa: F841 (names the launch)
                    upd = (w[:, :, None] * g_lvl[:, None, :]).reshape(-1, K * C)
                    g_parts.append(
                        launch_scatter_add_rows(rows_idx[lvl], upd, bmeta.level_rows(lvl)))
                if not ctx.input_grad:
                    continue
                # d out / d frac_d = Σ_k sign_d(k) Π_{d'≠d} w_d'(k) · rows_k·g
                vg = (rows_saved[lvl] * g_lvl[:, None, :]).sum(dim=-1)  # [M, K]
                scale = level_scale(meta, lvl)
                for d in range(D):
                    sign = torch.where(bits[None, :, d] == 1, 1.0, -1.0)
                    wpart = None
                    for dd in range(D):
                        if dd == d:
                            continue
                        wdd = torch.where(bits[None, :, dd] == 1, frac[dd][:, None],
                                          1.0 - frac[dd][:, None])
                        wpart = wdd if wpart is None else wpart * wdd
                    terms = sign * (wpart if wpart is not None else 1.0) * vg
                    dw = terms.sum(dim=-1)
                    if meta.interpolation == "smoothstep":
                        pos = comps[d] * scale + (0.0 if meta.align_corners else 0.5)
                        raw = pos - torch.floor(pos)
                        dw = dw * (6.0 * raw * (1.0 - raw))
                    grad_comps[d] = grad_comps[d] + dw * scale
            grad_emb = None
            if ctx.needs_input_grad[1]:
                grad_emb = _block_tables_adjoint(g_parts, bmeta).to(ctx.emb_dtype)
            if grad_comps is not None:
                grad_comps = [torch.where(oob, 0.0, gc) for gc in grad_comps]
            else:
                grad_comps = [None] * D
            return (None, grad_emb, *grad_comps)


def fast_grid_encode(inputs, embeddings: torch.Tensor, bmeta: BlockGridMeta) -> torch.Tensor:
    """Block-layout grid encode of the canonical ``[n_entries, C]`` table
    → ``[..., L*C]`` float32, differentiable in the table and the inputs
    (``inputs``: ``[..., D]`` in [0, 1] or a tuple of ``D`` columns)."""
    meta = bmeta.base
    prefix, cols, _, _ = _split_inputs(inputs, meta.input_dim)
    out = _FastGridEncode.apply(bmeta, embeddings, *cols)
    return out.reshape(*prefix, meta.num_levels * meta.level_dim)
