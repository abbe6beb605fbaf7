"""Fused multi-resolution grid encoder, forward and backward (port of
``geneface_tpu/ops/fused_grid.py``).

The parameter layout is the JAX package's: level 0 (and, with
``ungroup_coarse``, the next few levels) is a dense canonical table
``[side^D, C]``; the remaining levels are fused into groups whose rows hold
the ``K = 2^D`` corner features of every level of the group (``[R_g, G*K*C]``),
keyed by the prime-xor hash of the group's finest level's block.

The function is computed directly: gather one row per (sample, group) with
the K8 kernel, weight each level's ``K`` corners by its own interpolation
weights, and sum over corners. The TPU's selector-matmul lane layout is not
needed here. Inputs outside [0, 1] give zeros. The backward scatters the
table gradients with one K1 launch per group into the fast-view tables;
autograd of :func:`dense_view` carries a dense group's gradient on to its
canonical table. The forward saves the row indices and, for the input
gradients, the gathered rows; the corner weights are recomputed from the
inputs (``[M, G*K]``, an eighth of the channel-expanded ``[M, G*K*C]``
residual the JAX package saves).

``compute`` ``bf16`` (every group) or ``mixed`` (hash groups only) computes
a group's wide tensors at the JAX package's rounding points: K8 gathers the
rows from a bfloat16 copy of the table, the corner weights are rounded to
bfloat16, each ``weight · row`` product is rounded to bfloat16, and the
corner sum accumulates in float32. ``bwd_compute`` ``bf16`` (or a bfloat16
group) rounds the backward's cotangent, its products and the saved rows
(and, for ``bwd_compute`` only, the per-axis weights) to bfloat16, and K1
adds bfloat16 updates into float32 sums. Parameters and their gradients
stay float32 in every mode.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.profiler import record_function

from geneface_tpu_torch.ops.encoders import HASH_PRIMES, GridMeta, level_scale, parity_copies
from geneface_tpu_torch.ops.scatter import launch_gather_rows, launch_scatter_add_rows

__all__ = ["FusedGridMeta", "make_fused_grid_meta", "dense_view", "fused_grid_encode"]

_U32 = 0xFFFFFFFF


class FusedGridMeta(NamedTuple):
    base: GridMeta
    groups: tuple  # level-index tuples, e.g. ((0,), (1, ..., 7))
    modes: tuple  # per group: "dense" | "hash"
    n_rows: tuple  # rows of each group's (fast-view) table
    dense_sides: tuple  # per group: entries per axis of the dense level (0 if hash)
    dense_bsides: tuple  # per group: blocks per axis (0 if hash)
    spread: bool = False  # the inputs fall evenly over the tables: K1 skips ``smem``
    #: "f32" | "bf16" | "mixed": dtype of the forward's rows and products
    #: ("mixed": bfloat16 for hash groups, float32 for dense ones)
    compute: str = "f32"
    #: "same" | "bf16": dtype of the backward's residuals and cotangent
    bwd_compute: str = "same"

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

    def group_bf16(self, g: int) -> bool:
        """Whether group ``g``'s forward computes in bfloat16."""
        return self.compute == "bf16" or (self.compute == "mixed" and self.modes[g] == "hash")

    def group_bwd_bf16(self, g: int) -> bool:
        """Whether group ``g``'s backward computes in bfloat16."""
        return self.bwd_compute == "bf16" or self.group_bf16(g)


def make_fused_grid_meta(
    meta: GridMeta,
    single_table: bool = False,
    row_lanes: int = 256,
    ungroup_coarse: int = 0,
    coarse_run: int = 1,
    spread: bool = False,
    compute: str = "f32",
    bwd_compute: str = "same",
) -> FusedGridMeta:
    """Default grouping: level 0 alone, then ``ungroup_coarse`` levels in
    runs of ``coarse_run``, then the rest in runs of ``row_lanes // (K*C)``
    levels. The grouping fixes the checkpoint's table shapes. ``spread``:
    the grid's inputs fall evenly over its tables, which the backward's row
    scatter-adds pass to K1's dispatcher. ``compute`` and ``bwd_compute``:
    see the module docstring."""
    if compute not in ("f32", "bf16", "mixed"):
        raise ValueError(f"compute must be 'f32', 'bf16' or 'mixed', got {compute!r}")
    if bwd_compute not in ("same", "bf16"):
        raise ValueError(f"bwd_compute must be 'same' or 'bf16', got {bwd_compute!r}")
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
        resolution = int(math.ceil(level_scale(meta, g[0]))) + 1
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
        spread=bool(spread),
        compute=compute,
        bwd_compute=bwd_compute,
    )


def table_shape(fmeta: FusedGridMeta, gi: int) -> tuple:
    """Parameter shape of group ``gi`` (canonical for dense groups)."""
    if fmeta.modes[gi] == "dense":
        return (fmeta.dense_sides[gi] ** fmeta.input_dim, fmeta.level_dim)
    return (fmeta.n_rows[gi], fmeta.group_width(gi))


def dense_view(table: torch.Tensor, fmeta: FusedGridMeta, gi: int) -> torch.Tensor:
    """Canonical dense ``[side^D, C]`` → parity-copied view
    ``[K*bside^D, K*C]`` (:func:`~geneface_tpu_torch.ops.encoders.parity_copies`):
    row ``parity*bside^D + block`` holds the ``K`` corner entries of every
    cell whose base has that parity. A per-checkpoint constant: the
    renderer builds it once per video."""
    return parity_copies(
        table, fmeta.dense_sides[gi], fmeta.dense_bsides[gi], fmeta.input_dim
    ).contiguous()


def _fracs(comps, meta: GridMeta, lvl: int):
    """Per-axis integer base cell, interpolation fraction and, per axis,
    d(fraction)/d(input) of one level."""
    scale = level_scale(meta, lvl)
    off = 0.0 if meta.align_corners else 0.5
    base, frac, chain = [], [], []
    for c in comps:
        pos = c * scale + off
        pf = torch.floor(pos)
        f = pos - pf
        if meta.interpolation == "smoothstep":
            chain.append(6.0 * f * (1.0 - f) * scale)
            f = f * f * (3.0 - 2.0 * f)
        else:
            chain.append(scale)
        base.append(pf.to(torch.int64))
        frac.append(f)
    return base, frac, chain


def _group_rows(comps, fmeta: FusedGridMeta, gi: int) -> torch.Tensor:
    """int32 row of group ``gi`` per sample: parity-block address for dense
    groups; for hash groups the prime-xor hash (wrapping uint32, computed in
    int64 and masked) of the finest level's block coords and parity."""
    meta = fmeta.base
    D = meta.input_dim
    lvl = fmeta.groups[gi][-1] if fmeta.modes[gi] == "hash" else fmeta.groups[gi][0]
    base = _fracs(comps, meta, lvl)[0]
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
        return (parity * (bside**D) + blk).to(torch.int32)
    h = (bcoords[0] * HASH_PRIMES[0]) & _U32
    for d in range(1, D):
        h = h ^ ((bcoords[d] * HASH_PRIMES[d]) & _U32)
    h = h ^ ((parity * HASH_PRIMES[min(D, 6)]) & _U32)
    return (h % fmeta.n_rows[gi]).to(torch.int32)


def _axis_weights(comps, meta: GridMeta, levels, K: int):
    """Per-axis corner weights ``D x [M, G, K]`` of a run of levels (corner
    bit ``d`` of ``k`` picks ``frac_d`` over ``1 - frac_d``) and the
    per-axis chain factors ``D x [M, G]`` (or ``[G]`` for linear)."""
    D = meta.input_dim
    per_level = [_fracs(comps, meta, lvl) for lvl in levels]
    bits = torch.arange(K, device=comps[0].device)
    w_ax, chain = [], []
    for d in range(D):
        fd = torch.stack([pl[1][d] for pl in per_level], dim=-1)[..., None]  # [M, G, 1]
        w_ax.append(torch.where(((bits >> d) & 1) == 1, fd, 1.0 - fd))
        cs = [pl[2][d] for pl in per_level]
        chain.append(
            torch.stack(cs, dim=-1) if torch.is_tensor(cs[0])
            else torch.tensor(cs, dtype=torch.float32, device=comps[0].device)
        )
    return w_ax, chain


def _prod(ts, bf16: bool = False):
    """Product of ``ts`` left to right, each step rounded to bfloat16 when
    ``bf16`` (the bfloat16 multiplies of the JAX package)."""
    out = ts[0]
    for t in ts[1:]:
        out = _round(out * t, bf16)
    return out


def _round(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    """``t`` rounded to bfloat16 (kept float32) when ``bf16``."""
    return t.to(torch.bfloat16).float() if bf16 else t


class _FusedGridEncode(torch.autograd.Function):
    """Forward: one K8 row gather per group, then the corner-weighted sum.
    Backward (``_fge_bwd`` of the JAX package): the table gradients
    ``upd = w · g`` (corner weights times the output gradient, broadcast
    over channels) through one K1 row scatter per group into the group's
    fast-view table, and, when asked, the input gradients from the saved
    gathered rows (no re-gather)."""

    @staticmethod
    def forward(ctx, fmeta, need_input_grad, *args):
        meta = fmeta.base
        D, C = meta.input_dim, meta.level_dim
        K = 1 << D
        comps_raw, tables = args[:D], args[D:]
        oob = torch.zeros_like(comps_raw[0], dtype=torch.bool)
        for c in comps_raw:
            oob = oob | (c < 0.0) | (c > 1.0)
        comps = [c.clamp(0.0, 1.0) for c in comps_raw]
        M = comps[0].shape[0]
        input_grad = bool(need_input_grad) and any(ctx.needs_input_grad[2 : 2 + D])
        outs, rows_idx, rows_saved = [], [], []
        for gi, g in enumerate(fmeta.groups):
            G = len(g)
            bf16 = fmeta.group_bf16(gi)
            row = _group_rows(comps, fmeta, gi)
            table = tables[gi].to(torch.bfloat16) if bf16 else tables[gi]
            rows = launch_gather_rows(table.contiguous(), row).reshape(M, G, K, C)
            w = _round(_prod(_axis_weights(comps, meta, g, K)[0]), bf16)  # [M, G, K]
            outs.append(_round(w[..., None] * rows, bf16).sum(dim=2).reshape(M, G * C))
            rows_idx.append(row)
            if input_grad:
                # the backward's residual, half-width where it computes in bf16
                rows_saved.append(rows.to(torch.bfloat16) if fmeta.group_bwd_bf16(gi) else rows)
        out = torch.where(oob[:, None], 0.0, torch.cat(outs, dim=-1))
        ctx.fmeta = fmeta
        ctx.input_grad = input_grad
        ctx.save_for_backward(oob, *comps, *rows_idx, *rows_saved)
        return out

    @staticmethod
    def backward(ctx, gout):
        with record_function("gf::grid_backward"):
            fmeta = ctx.fmeta
            meta = fmeta.base
            D, C = meta.input_dim, meta.level_dim
            K = 1 << D
            n_groups = len(fmeta.groups)
            saved = ctx.saved_tensors
            oob, comps = saved[0], list(saved[1 : 1 + D])
            rows_idx = saved[1 + D : 1 + D + n_groups]
            rows_saved = saved[1 + D + n_groups :]
            M = comps[0].shape[0]
            g2 = torch.where(oob[:, None], 0.0, gout.float())
            grad_comps = [None] * D
            grad_tables = [None] * n_groups
            for gi, g in enumerate(fmeta.groups):
                G = len(g)
                bf16 = fmeta.group_bwd_bf16(gi)
                gg = _round(g2[:, g[0] * C : (g[-1] + 1) * C], bf16).reshape(M, G, 1, C)
                w_ax, chain = _axis_weights(comps, meta, g, K)
                if ctx.needs_input_grad[2 + D + gi]:
                    upd = _round(_prod(w_ax), bf16)[..., None] * gg
                    # bf16: K1 adds the rounded products as bfloat16 updates
                    upd = (upd.to(torch.bfloat16) if bf16 else upd).reshape(M, G * K * C)
                    grad_tables[gi] = launch_scatter_add_rows(rows_idx[gi], upd, fmeta.n_rows[gi],
                                                              spread=fmeta.spread)
                if not ctx.input_grad:
                    continue
                if fmeta.bwd_compute == "bf16":
                    w_ax = [_round(w, True) for w in w_ax]  # the half-width residuals
                # d out / d comp_d = Σ_k rows · sign_d(k) · chain_d · Π_{d'≠d} w_d'
                rg = _round(rows_saved[gi].float() * gg, bf16).sum(dim=-1)  # [M, G, K]
                bits = torch.arange(K, device=rg.device)
                for d in range(D):
                    sign = 2.0 * ((bits >> d) & 1).float() - 1.0  # [K]
                    cd = chain[d][..., None]  # [M, G, 1] or [G, 1]
                    others = [w_ax[e] for e in range(D) if e != d]
                    term = rg * sign * cd
                    if others:
                        term = term * _prod(others, fmeta.bwd_compute == "bf16")
                    contrib = term.sum(dim=(1, 2))
                    grad_comps[d] = contrib if grad_comps[d] is None else grad_comps[d] + contrib
            if ctx.input_grad:
                grad_comps = [torch.where(oob, 0.0, gc) for gc in grad_comps]
            return (None, None, *grad_comps, *grad_tables)


def fused_grid_encode(
    inputs: torch.Tensor | tuple,
    tables: list,
    fmeta: FusedGridMeta,
    need_input_grad: bool = True,
) -> torch.Tensor:
    """Grouped multi-resolution interpolation → ``[..., L*C]`` float32.

    ``inputs``: ``[..., D]`` in [0, 1], or a tuple of ``D`` coordinate
    columns. ``tables[gi]``: the group's fast-view table — :func:`dense_view`
    of the canonical table for dense groups, the parameter itself for hash
    groups. Differentiable in the tables and, with ``need_input_grad``, in
    the inputs (outside [0, 1] the output and every gradient are zero).
    ``need_input_grad=False`` skips the input gradients: the position grid's
    samples come from stop-gradient rays.
    """
    meta = fmeta.base
    D = meta.input_dim
    if isinstance(inputs, (tuple, list)):
        prefix = inputs[0].shape
        comps = [c.reshape(-1).float() for c in inputs]
    else:
        prefix = inputs.shape[:-1]
        x = inputs.reshape(-1, D).float()
        comps = [x[:, d] for d in range(D)]
    out = _FusedGridEncode.apply(fmeta, need_input_grad, *comps, *tables)
    return out.reshape(*prefix, meta.num_levels * meta.level_dim)
