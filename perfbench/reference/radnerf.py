"""Plain PyTorch reference of the RAD-NeRF head and torso, as the benchmark
checks them: the grids, the condition nets and the MLPs, the lattice march
and the walk, the compaction, the composite, the k-DOP cull, the occupancy
sweeps, the torso, the losses and the multi-group Adam.

A frozen copy of the arithmetic of ``geneface_tpu_torch``'s plain CPU path,
written against plain tensors: no row-gather or row-scatter kernel (indexing
and autograd stand in), no caches, no retuned buffers of the program. It
imports nothing of the program and reads none of its state: every constant
that the program derives at set-up (the grids' views, the occupancy blocks,
the k-DOP, the ray capacity, the torso mask) is worked out again here from
the benchmark's own weights and scene.

Precision: the head MLPs round their operands to bfloat16 and accumulate in
float32, as the configuration states; everything else is float32 with TF32
off. ``grid_bf16`` computes the grids' wide products in bfloat16, the
nearest precision below the configuration's float32 grid: the control.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

HASH_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)
_U32 = 0xFFFFFFFF
_SQRT3 = math.sqrt(3.0)
_FMAX = torch.finfo(torch.float32).max


def set_full_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------------ grids ----
class GridMeta(NamedTuple):
    input_dim: int
    num_levels: int
    level_dim: int
    base_resolution: int
    per_level_scale: float
    offsets: tuple


def make_grid_meta(input_dim, num_levels, level_dim, log2_hashmap_size,
                   desired_resolution, base_resolution=16) -> GridMeta:
    """Level layout of the gridencoder: ``min(2^log2, side^D)`` entries a
    level, rounded up to a multiple of 8 (tiled, unaligned corners)."""
    scale = float(np.exp2(np.log2(desired_resolution / base_resolution)
                          / max(num_levels - 1, 1)))
    offsets = [0]
    for lvl in range(num_levels):
        side = int(np.ceil(base_resolution * scale**lvl)) + 1
        n = min(2**log2_hashmap_size, side**input_dim)
        offsets.append(offsets[-1] + int(np.ceil(n / 8) * 8))
    return GridMeta(input_dim, num_levels, level_dim, base_resolution, scale, tuple(offsets))


def level_scale(meta: GridMeta, lvl: int) -> float:
    return math.exp2(lvl * math.log2(meta.per_level_scale)) * meta.base_resolution - 1.0


class GroupedGrid(NamedTuple):
    """The grouped-row parameterisation of a grid: level 0 a dense table,
    the other levels one group whose rows hold the ``K`` corners of each of
    its levels, keyed by the prime-xor hash of the finest level's block."""

    meta: GridMeta
    groups: tuple
    modes: tuple
    n_rows: tuple
    sides: tuple
    bsides: tuple

    def shape(self, gi: int) -> tuple:
        D, C = self.meta.input_dim, self.meta.level_dim
        if self.modes[gi] == "dense":
            return (self.sides[gi] ** D, C)
        return (self.n_rows[gi], len(self.groups[gi]) * (1 << D) * C)


def grouped_grid(meta: GridMeta, row_lanes: int = 256) -> GroupedGrid:
    D, C = meta.input_dim, meta.level_dim
    K = 1 << D
    per_row = max(1, row_lanes // (K * C))
    rest = list(range(1, meta.num_levels))
    groups = ((0,),) + tuple(tuple(rest[i:i + per_row]) for i in range(0, len(rest), per_row))
    modes, n_rows, sides, bsides = [], [], [], []
    for g in groups:
        size = meta.offsets[g[0] + 1] - meta.offsets[g[0]]
        side = int(math.ceil(level_scale(meta, g[0]))) + 2
        if len(g) == 1 and side**D <= size:
            modes.append("dense")
            sides.append(side)
            bsides.append(side // 2 + 1)
            n_rows.append(K * (side // 2 + 1) ** D)
        else:
            modes.append("hash")
            sides.append(0)
            bsides.append(0)
            total = sum(meta.offsets[lv + 1] - meta.offsets[lv] for lv in g)
            n_rows.append(max(total // (len(g) * K), 1))
    return GroupedGrid(meta, tuple(groups), tuple(modes), tuple(n_rows), tuple(sides),
                       tuple(bsides))


def parity_rows(dense_flat: torch.Tensor, side: int, bside: int, D: int) -> torch.Tensor:
    """Dense ``[side^D, C]`` → ``[K·bside^D, K·C]``: row ``parity·bside^D +
    block`` holds the ``K`` corner entries of the cell of that base parity."""
    K = 1 << D
    C = dense_flat.shape[-1]
    dense = dense_flat.reshape((side,) * D + (C,))
    padded = F.pad(dense.movedim(-1, 0), (1, 2) * D).movedim(0, -1)
    copies = []
    for parity in range(K):
        for corner in range(K):
            starts = [1 - ((parity >> (D - 1 - a)) & 1) + ((corner >> (D - 1 - a)) & 1)
                      for a in range(D)]
            sl = padded[tuple(slice(s, s + 2 * bside - 1, 2) for s in starts)]
            copies.append(sl.reshape(-1, C))
    return torch.stack(copies, 0).reshape(K, K, -1, C).permute(0, 2, 1, 3).reshape(-1, K * C)


def _fracs(comps, meta: GridMeta, lvl: int):
    scale = level_scale(meta, lvl)
    base, frac = [], []
    for c in comps:
        pos = c * scale + 0.5
        pf = torch.floor(pos)
        base.append(pf.detach().to(torch.int64))
        frac.append(pos - pf)
    return base, frac


def _group_rows(comps, grid: GroupedGrid, gi: int) -> torch.Tensor:
    D = grid.meta.input_dim
    lvl = grid.groups[gi][-1] if grid.modes[gi] == "hash" else grid.groups[gi][0]
    base = _fracs(comps, grid.meta, lvl)[0]
    pbits = [b & 1 for b in base]
    bcoords = [(b + p) >> 1 for b, p in zip(base, pbits)]
    parity = pbits[0]
    for d in range(1, D):
        parity = parity + (pbits[d] << d)
    if grid.modes[gi] == "dense":
        bside = grid.bsides[gi]
        blk, stride = bcoords[0], bside
        for d in range(1, D):
            blk = blk + bcoords[d] * stride
            stride *= bside
        return parity * (bside**D) + blk
    h = (bcoords[0] * HASH_PRIMES[0]) & _U32
    for d in range(1, D):
        h = h ^ ((bcoords[d] * HASH_PRIMES[d]) & _U32)
    h = h ^ ((parity * HASH_PRIMES[min(D, 6)]) & _U32)
    return h % grid.n_rows[gi]


def _bf16(t: torch.Tensor, on: bool) -> torch.Tensor:
    return t.to(torch.bfloat16).float() if on else t


def grid_views(grid: GroupedGrid, params: list) -> list:
    """The tables the encoder reads: dense groups as their parity rows."""
    D = grid.meta.input_dim
    return [parity_rows(p, grid.sides[gi], grid.bsides[gi], D) if grid.modes[gi] == "dense"
            else p for gi, p in enumerate(params)]


def grid_encode(comps: list, grid: GroupedGrid, views: list, bf16: bool = False) -> torch.Tensor:
    """Multi-resolution interpolation of ``D`` coordinate columns in [0, 1]
    → ``[M, L·C]``; zero outside [0, 1]. Differentiable (autograd)."""
    meta = grid.meta
    D, C = meta.input_dim, meta.level_dim
    K = 1 << D
    oob = torch.zeros_like(comps[0], dtype=torch.bool)
    for c in comps:
        oob = oob | (c < 0.0) | (c > 1.0)
    comps = [c.clamp(0.0, 1.0) for c in comps]
    M = comps[0].shape[0]
    bits = torch.arange(K, device=comps[0].device)
    outs = []
    for gi, g in enumerate(grid.groups):
        G = len(g)
        row = _group_rows(comps, grid, gi)
        table = views[gi].to(torch.bfloat16).float() if bf16 else views[gi]
        rows = table[row].reshape(M, G, K, C)
        fr = [_fracs(comps, meta, lv)[1] for lv in g]
        w = None
        for d in range(D):
            fd = torch.stack([f[d] for f in fr], dim=-1)[..., None]
            wd = torch.where(((bits >> d) & 1) == 1, fd, 1.0 - fd)
            w = wd if w is None else _bf16(w * wd, bf16)
        w = _bf16(w, bf16)
        outs.append(_bf16(w[..., None] * rows, bf16).sum(dim=2).reshape(M, G * C))
    return torch.where(oob[:, None], 0.0, torch.cat(outs, dim=-1))


# ------------------------------------------------------------- the nets ----
class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.float()
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def trunc_exp(x):
    return _TruncExp.apply(x)


def _split_linear(parts, weight, dtype):
    w = weight.to(dtype).float()
    off, y = 0, None
    for p in parts:
        c = p.shape[-1]
        term = p.to(dtype).float() @ w[:, off:off + c].T
        y = term if y is None else y + term
        off += c
    return y


def mlp(parts, weights: list, dtype, split_out=None):
    """Bias-free ReLU MLP; operands rounded to ``dtype``, float32 sums, each
    layer's output rounded to ``dtype`` once."""
    parts = list(parts)
    for w in weights[:-1]:
        parts = [F.relu(_split_linear(parts, w, dtype).to(dtype))]
    y = _split_linear(parts, weights[-1], dtype)
    if split_out is None:
        return y.to(dtype).float()
    outs, off = [], 0
    for width in split_out:
        col = y[..., off:off + width].to(dtype).float()
        outs.append(col[..., 0] if width == 1 else col)
        off += width
    return tuple(outs)


_STRIDES = {1: (1, 1, 1, 1), 2: (2, 1, 1, 1), 3: (2, 2, 1, 1), 4: (2, 2, 1, 1),
            5: (2, 2, 2, 1), 8: (2, 2, 2, 1), 16: (2, 2, 2, 2)}


def _conv(x, w, b, stride=1):
    return F.conv1d(x.transpose(1, 2), w, b, stride=stride, padding=1).transpose(1, 2)


def _lrelu(x):
    return F.leaky_relu(x, 0.02)


def cond_feature(P: dict, cond: torch.Tensor, win_size: int, with_att: bool = True):
    """``[B_smo, W, C_in]`` → ``[1, 64]``: the strided conv stack, then the
    attention over the smoothing window."""
    x = cond
    for i, s in enumerate(_STRIDES[win_size]):
        x = _lrelu(_conv(x, P[f"cond_prenet.convs.{i}.weight"], P[f"cond_prenet.convs.{i}.bias"], s))
    x = x.mean(dim=1) if x.shape[1] > 1 else x[:, 0]
    x = F.linear(_lrelu(F.linear(x, P["cond_prenet.fc1.weight"], P["cond_prenet.fc1.bias"])),
                 P["cond_prenet.fc2.weight"], P["cond_prenet.fc2.bias"])
    if not with_att:
        return x
    seq = x.shape[0]
    y = x[None]
    for i in range(5):
        y = _lrelu(_conv(y, P[f"cond_att_net.convs.{i}.weight"], P[f"cond_att_net.convs.{i}.bias"]))
    y = y.reshape(1, seq)
    w = torch.softmax(F.linear(y, P["cond_att_net.fc.weight"], P["cond_att_net.fc.bias"]), dim=-1)
    return (w.reshape(seq, 1) * x).sum(dim=0)[None]


def sh4(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics of degree 4 (instant-ngp's signs)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    out = [torch.full_like(x, 0.28209479177387814),
           -0.48860251190291987 * y, 0.48860251190291987 * z, -0.48860251190291987 * x,
           1.0925484305920792 * xy, -1.0925484305920792 * yz,
           0.94617469575755997 * z2 - 0.31539156525251999, -1.0925484305920792 * xz,
           0.54627421529603959 * x2 - 0.54627421529603959 * y2,
           0.59004358992664352 * y * (-3.0 * x2 + y2), 2.8906114426405538 * xy * z,
           0.45704579946446572 * y * (1.0 - 5.0 * z2), 0.3731763325901154 * z * (5.0 * z2 - 3.0),
           0.45704579946446572 * x * (1.0 - 5.0 * z2), 1.4453057213202769 * z * (x2 - y2),
           0.59004358992664352 * x * (-x2 + 3.0 * y2)]
    return torch.stack(out, dim=-1)


def freq_encode(x, degree):
    cols = [x]
    for f in range(degree):
        cols += [torch.sin(x * 2.0**f), torch.cos(x * 2.0**f)]
    return torch.cat(cols, dim=-1)


class Head:
    """The head field over the benchmark's parameters ``P`` (state-dict
    names). ``mlp_dtype`` is the configuration's; ``grid_bf16`` the control."""

    def __init__(self, cfg: dict, P: dict, mlp_dtype=torch.bfloat16, grid_bf16=False):
        self.cfg, self.P = cfg, P
        self.dtype, self.grid_bf16 = mlp_dtype, grid_bf16
        self.bound = float(cfg["bound"])
        pos, amb = head_grids(cfg)
        self.pos, self.amb = pos, amb

    def views(self):
        P = self.P
        return (grid_views(self.pos, [P[f"pos_embeddings.group_{i}"] for i in range(len(self.pos.groups))]),
                grid_views(self.amb, [P[f"ambient_embeddings.group_{i}"] for i in range(len(self.amb.groups))]))

    def cond(self, cond_wins):
        return cond_feature(self.P, cond_wins, int(self.cfg["cond_win_size"]), bool(self.cfg["with_att"]))

    def _pos_amb(self, xyz, cond_feat, views):
        P, dt = self.P, self.dtype
        x01 = (xyz + self.bound) / (2 * self.bound)
        pos_feat = grid_encode([x01[:, d] for d in range(3)], self.pos, views[0], self.grid_bf16)
        logits = mlp([pos_feat, cond_feat.reshape(1, -1)],
                     [P[f"ambient_net.layers.{i}.weight"] for i in range(int(self.cfg["num_layers_ambient"]))],
                     dt, split_out=(1, 1))
        tanhs = [torch.tanh(lg.float()) for lg in logits]
        amb_feat = grid_encode([(t + 1.0) / 2.0 for t in tanhs], self.amb, views[1], self.grid_bf16)
        return pos_feat, amb_feat, torch.stack(tanhs, dim=-1)

    def density(self, xyz, cond_feat, views):
        pos_feat, amb_feat, _ = self._pos_amb(xyz, cond_feat, views)
        sig, _ = mlp([pos_feat, amb_feat], self._w("sigma_net", "num_layers_sigma"), self.dtype,
                     split_out=(1, int(self.cfg["geo_feat_dim"])))
        return trunc_exp(sig)

    def _w(self, name, key):
        return [self.P[f"{name}.layers.{i}.weight"] for i in range(int(self.cfg[key]))]

    def __call__(self, xyz, dirs, cond_feat, code, views):
        pos_feat, amb_feat, amb = self._pos_amb(xyz, cond_feat, views)
        sig, geo = mlp([pos_feat, amb_feat], self._w("sigma_net", "num_layers_sigma"), self.dtype,
                       split_out=(1, int(self.cfg["geo_feat_dim"])))
        parts = [sh4(dirs), geo, code.reshape(1, -1)]
        color = torch.sigmoid(mlp(parts, self._w("color_net", "num_layers_color"), self.dtype))
        return trunc_exp(sig), color, amb


def head_grids(cfg: dict) -> tuple:
    L, C = int(cfg["grid_num_levels"]), int(cfg["grid_level_dim"])
    cap = int(cfg["log2_hashmap_size"]) - int(round(math.log2(C / 2)))
    bound = float(cfg["bound"])
    lanes = int(cfg["fused_row_lanes"])
    pos = make_grid_meta(3, L, C, cap, int(int(cfg["desired_resolution"]) * bound))
    amb = make_grid_meta(2, L, C, cap, int(cfg["desired_resolution"]))
    return grouped_grid(pos, lanes), grouped_grid(amb, lanes)


def torso_grid(cfg: dict) -> GroupedGrid:
    L, C = int(cfg["grid_num_levels"]), int(cfg["grid_level_dim"])
    meta = make_grid_meta(2, L, C, 16 - int(round(math.log2(C / 2))), 2048)
    return grouped_grid(meta, int(cfg["fused_row_lanes"]))


class Torso:
    """The torso deformation field: frequency-encoded coordinate and pose,
    the torso code, the deform MLP, the 2-D grid and the canonical MLP,
    float32."""

    def __init__(self, cfg: dict, P: dict, grid_bf16=False):
        self.cfg, self.P, self.grid_bf16 = cfg, P, grid_bf16
        self.grid = torso_grid(cfg)
        self.shrink = float(cfg["torso_shrink"])

    def views(self):
        return grid_views(self.grid, [self.P[f"torso_embeddings.group_{i}"]
                                      for i in range(len(self.grid.groups))])

    def __call__(self, xy, pose6, code, views):
        P = self.P
        N = xy.shape[0]
        x = xy.float() * self.shrink
        h = torch.cat([freq_encode(x, 10), freq_encode(pose6.float(), 4).expand(N, -1),
                       code.float().reshape(1, -1).expand(N, -1)], dim=-1)
        dx = mlp([h], [P[f"torso_deform_net.layers.{i}.weight"] for i in range(3)], torch.float32)
        x_def = (x + dx).clamp(-1.0, 1.0)
        u = (x_def + 1.0) / 2.0
        feat = grid_encode([u[:, 0], u[:, 1]], self.grid, views, self.grid_bf16)
        out = mlp([torch.cat([feat, h], dim=-1)],
                  [P[f"torso_canonical_net.layers.{i}.weight"] for i in range(3)], torch.float32)
        return torch.sigmoid(out[..., :1]), torch.sigmoid(out[..., 1:]), dx


# ---------------------------------------------------------------- march ----
def fma_f32(a, b, c):
    if not torch.is_tensor(b):
        b = float(torch.tensor(b, dtype=torch.float32))
    c = c.double() if torch.is_tensor(c) else float(torch.tensor(c, dtype=torch.float32))
    return (a.double() * b + c).float()


def make_aabb(bound, device):
    b = float(bound)
    return torch.tensor([-b, -b / 2, -b, b, b / 2, b], dtype=torch.float32, device=device)


def near_far(o, d, aabb, min_near):
    inv = 1.0 / d
    t0 = (aabb[:3] - o) * inv
    t1 = (aabb[3:] - o) * inv
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    miss = near > far
    near = near.clamp(min=min_near)
    return torch.where(miss, _FMAX, near), torch.where(miss, _FMAX, far)


def occupied_box(occ0, bound):
    H = occ0.shape[0]
    idx = torch.arange(H, dtype=torch.float32, device=occ0.device)
    mb = min(1.0, bound)
    los, his = [], []
    for ax in ((1, 2), (0, 2), (0, 1)):
        any_i = occ0.any(dim=ax[1]).any(dim=ax[0])
        lo = torch.where(any_i, idx, float(H)).amin()
        hi = torch.where(any_i, idx, -1.0).amax()
        los.append(((lo - 1.0) / H * 2.0 - 1.0) * mb)
        his.append(((hi + 2.0) / H * 2.0 - 1.0) * mb)
    b = float(bound)
    full = torch.tensor([-b, -b, -b, b, b, b], device=occ0.device)
    empty = ~occ0.any()
    los = torch.where(empty, full[:3], torch.maximum(torch.stack(los), full[:3]))
    his = torch.where(empty, full[3:], torch.minimum(torch.stack(his), full[3:]))
    return torch.cat([los, his])


class March(NamedTuple):
    ts: torch.Tensor
    dts: torch.Tensor
    valid: torch.Tensor
    depth_ts: torch.Tensor
    span: torch.Tensor | None


def march_lattice(o, d, occ0, nears, fars, noises, *, bound, max_steps, grid_size, lattice_K):
    """The uniform-dt march: the first ``max_steps`` occupied lattice points
    ``t0 + k·dt`` of each ray inside the tight occupied box, of the first
    ``lattice_K`` after the fast-forward. Tests the bool grid directly."""
    N, H, K, S = o.shape[0], grid_size, lattice_K, max_steps
    dt = 2.0 * _SQRT3 / H
    if min(dt, 2.0 * _SQRT3 / max_steps) != dt:
        raise ValueError("the lattice march needs the uniform-dt regime")
    mb = min(1.0, bound)
    dev = o.device
    t0 = fma_f32(noises, dt, nears)
    tight = occupied_box(occ0, bound)
    tn, tf = near_far(o, d, tight, 0.0)
    k0 = torch.ceil((tn - t0).clamp(min=0.0) / dt - 1e-5)
    k0 = torch.where(tn > 1e30, float(2 * H), k0)
    t_start = fma_f32(k0, dt, t0)
    lo = torch.maximum(tn, nears)
    hi = torch.minimum(tf, fars)
    span = torch.ceil(torch.where((tn < 1e30) & (hi > lo), hi - lo, 0.0).amax() / dt).to(torch.int32) + 1
    ts = fma_f32(torch.arange(K, dtype=torch.float32, device=dev)[None, :], dt, t_start[:, None])
    in_range = ts < torch.minimum(fars, tf + dt)[:, None]
    cells = []
    for a in range(3):
        p = fma_f32(ts, d[:, a:a + 1].double(), o[:, a:a + 1]).clamp(-bound, bound)
        cells.append((0.5 * (p / mb + 1.0) * H).clamp(0.0, float(H - 1)).to(torch.int64))
    raw = occ0[cells[0], cells[1], cells[2]] & in_range
    rank = torch.cumsum(raw.to(torch.int32), dim=1) - 1
    slot = torch.where(raw & (rank < S), rank, S).to(torch.int64)
    kidx = torch.arange(K, dtype=torch.int32, device=dev).expand(N, K)
    ks = torch.zeros(N, S + 1, dtype=torch.int32, device=dev).scatter_(1, slot, kidx)[:, :S]
    n = raw.sum(dim=1).clamp(max=S)
    valid = torch.arange(S, device=dev)[None, :] < n[:, None]
    ks = torch.where(valid, ks, 0)
    t_sel = fma_f32(ks, dt, t_start[:, None])
    return March(torch.where(valid, t_sel, 0.0), torch.where(valid, dt, 0.0), valid,
                 torch.where(valid, t_sel + dt, 0.0), span)


def _skip_bytes(occ0):
    x = occ0.float()[None, None]
    byte = occ0.reshape(-1).to(torch.int64)
    for bit, r in enumerate((1, 2, 4, 8), start=1):
        for axis in range(3):
            k, pad = [1, 1, 1], [0, 0, 0]
            k[axis], pad[axis] = 2 * r + 1, r
            x = F.max_pool3d(x, tuple(k), stride=1, padding=tuple(pad))
        byte = byte | (x.reshape(-1).to(torch.int64) << bit)
    return byte


def march_walk(o, d, occ0, nears, fars, noises, *, bound, max_steps, grid_size, dt_gamma):
    """The walk of the reference CUDA march in the uniform-dt regime: emit at
    an occupied cell, else jump along the ray's lattice past the largest
    empty Chebyshev box around the cell."""
    N, S, H = o.shape[0], max_steps, grid_size
    dev = o.device
    inv_d = 1.0 / d
    dt_max = 2.0 * _SQRT3 / H
    dt_min = min(dt_max, 2.0 * _SQRT3 / max_steps)
    if dt_min != dt_max:
        raise ValueError("the reference walk covers the uniform-dt regime")
    mb = min(1.0, bound)
    strides = torch.tensor([H * H, H, 1], device=dev)
    t = fma_f32((nears * dt_gamma).clamp(dt_min, dt_max), noises.float(), nears)
    n_valid = torch.zeros(N, dtype=torch.int64, device=dev)
    buf = torch.zeros(N, S + 1, 3, device=dev)
    byte = _skip_bytes(occ0)
    dt = float(torch.tensor(dt_min, dtype=torch.float32))
    cs = 2.0 * mb / H
    radius = torch.tensor([15.0 if not v & 8 else 7.0 if not v & 4 else 3.0 if not v & 2 else
                           1.0 if not v & 1 else 0.0 for v in range(16)], device=dev)
    for it in range(2 * H + 2 * S):
        alive = (t < fars) & (n_valid < S)
        if it % 8 == 0 and not bool(alive.any()):
            break
        pos = fma_f32(t[:, None], d, o).clamp(-bound, bound)
        cell = (0.5 * (pos / mb + 1.0) * H).clamp(0.0, float(H - 1)).to(torch.int64)
        b = byte[(cell * strides).sum(dim=-1)]
        occ = (b & 1) > 0
        r = radius[(b >> 1) & 15][:, None]
        face = fma_f32(torch.where(d > 0, cell.float() + r + 1.0, cell.float() - r), cs, -mb)
        target = t + ((face - pos) * inv_d).amin(dim=-1).clamp(min=0.0)
        emit = alive & occ
        slot = torch.where(emit, n_valid, S)[:, None, None].expand(N, 1, 3)
        buf.scatter_(1, slot, torch.stack([t, torch.full_like(t, dt), t + dt], dim=-1)[:, None, :])
        n_valid = n_valid + emit.to(torch.int64)
        k = torch.ceil((target - t) / dt - 1e-5).clamp(min=1.0)
        t = torch.where(alive, torch.where(occ, t + dt, fma_f32(k, dt, t)), t)
    valid = torch.arange(S, device=dev)[None, :] < n_valid[:, None]
    ts, dts, dps = buf[:, :S].unbind(dim=-1)
    return March(ts, dts, valid, dps, None)


# ----------------------------------------------------------- compaction ----
def waterfill(valid, capacity):
    N, S = valid.shape
    summin = torch.cumsum(valid.sum(dim=0), dim=0)
    qstar = (summin <= capacity).sum()
    base = torch.where(qstar > 0, summin[(qstar - 1).clamp(min=0)], 0)
    rem = (capacity - base).clamp(min=0)
    has_extra = valid[:, qstar.clamp(max=S - 1)] & (qstar < S)
    extra = has_extra & (torch.cumsum(has_extra.to(torch.int64), dim=0) <= rem)
    slot = torch.arange(S, device=valid.device)[None, :]
    return valid & ((slot < qstar) | ((slot == qstar) & extra[:, None]))


def compact(valid, capacity, rec):
    """Ray-major compaction of the ``[N, S, ...]`` records ``rec`` under a
    prefix-dense ``[N, S]`` mask into ``capacity`` slots → (records, slot
    valid, slot's ray, slot starts its ray, samples a ray)."""
    N, S = valid.shape
    dev = valid.device
    n = valid.sum(dim=-1)
    csum = torch.cumsum(n, dim=0)
    offset = csum - n
    starts = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    starts.index_add_(0, offset.clamp(max=capacity), torch.ones_like(offset))
    ray = torch.cumsum(starts[:capacity], dim=0) - 1
    j = torch.arange(capacity, device=dev)
    vc = j < torch.clamp(csum[-1], max=capacity)
    in_ray = j - offset[ray.clamp(min=0)]
    src = torch.where(vc, ray * S + in_ray, 0)
    flat = rec.reshape(N * S, -1)[src]
    flat = torch.where(vc[:, None], flat, 0.0)
    return flat, vc, ray, in_ray == 0, n


def segmented_cumsum(v, is_start):
    M = v.shape[0]
    f = is_start.clone()
    k = 1
    while k < M:
        va = torch.cat([torch.zeros_like(v[:k]), v[:-k]])
        fa = torch.cat([torch.zeros_like(f[:k]), f[:-k]])
        v = v + torch.where(f, 0.0, va)
        f = f | fa
        k *= 2
    return v


# ---------------------------------------------------------------- render ----
def render_rays(field, o, d, occ0, *, bound, min_near, max_steps, grid_size, lattice_K,
                mean_samples_per_ray, bg, noises=None, T_thresh=1e-4):
    """The compact render of rays ``o, d`` (no gradient through the rays):
    the lattice march, the waterfilled compaction, the field, the
    front-to-back composite → dict of per-ray outputs."""
    N = o.shape[0]
    dev = o.device
    o, d = o.detach().float(), d.detach().float()
    nears, fars = near_far(o, d, make_aabb(bound, dev), min_near)
    noises = torch.zeros(N, device=dev) if noises is None else noises
    m = march_lattice(o, d, occ0, nears, fars, noises, bound=bound, max_steps=max_steps,
                      grid_size=grid_size, lattice_K=lattice_K)
    S = m.ts.shape[-1]
    capacity = min(int(-(-N * float(mean_samples_per_ray) // 1024) * 1024), N * S)
    keep = waterfill(m.valid, capacity)
    xyz = fma_f32(m.ts[..., None], d[:, None, :], o[:, None, :])
    rec = torch.cat([m.dts[..., None], m.depth_ts[..., None], xyz,
                     d[:, None, :].expand_as(xyz)], dim=-1)
    rc, vc, ray, is_start, n = compact(keep, capacity, rec)
    sigma, rgb, amb = field(rc[:, 2:5].clamp(-bound, bound), rc[:, 5:8])
    sd = torch.where(vc, sigma * rc[:, 0], 0.0)
    pref = segmented_cumsum(sd, is_start)
    T_before = torch.exp(-(pref - sd))
    alpha = 1.0 - torch.exp(-sd)
    include = (T_before >= T_thresh) & vc
    w = torch.where(include, alpha * T_before, 0.0)
    cols = torch.stack([w, w * rgb[:, 0], w * rgb[:, 1], w * rgb[:, 2], w * rc[:, 1],
                        torch.where(include, amb.abs().sum(dim=-1), 0.0)], dim=-1)
    rows = torch.where(vc, ray, N)
    sums = torch.zeros(N + 1, 6, device=dev).index_add(0, rows, cols)[:N]
    ws = sums[:, 0]
    image = (sums[:, 1:4] + (1.0 - ws)[:, None] * bg).clamp(0.0, 1.0)
    span = (fars - nears).clamp(min=1e-6)
    depth = torch.where(nears < 1e30, (sums[:, 4] - nears).clamp(min=0.0) / span, 0.0)
    return {"rgb_map": image, "weights_sum": ws, "depth_map": depth, "ambient_sum": sums[:, 5],
            "n_samples": keep.sum(dim=-1), "march_span": m.span, "valid": m.valid.sum()}


def render_slab(field, o, d, occ0, *, bound, min_near, max_steps, grid_size, dt_gamma, bg,
                noises=None, T_thresh=1e-4):
    """The walk, the field on the whole ``[N, max_steps]`` slab, the slab
    composite."""
    N = o.shape[0]
    dev = o.device
    o, d = o.detach().float(), d.detach().float()
    nears, fars = near_far(o, d, make_aabb(bound, dev), min_near)
    noises = torch.zeros(N, device=dev) if noises is None else noises
    m = march_walk(o, d, occ0, nears, fars, noises, bound=bound, max_steps=max_steps,
                   grid_size=grid_size, dt_gamma=dt_gamma)
    S = m.ts.shape[-1]
    xyz = fma_f32(m.ts[..., None], d[:, None, :], o[:, None, :]).clamp(-bound, bound)
    sigma, rgb, amb = field(xyz.reshape(-1, 3), d[:, None, :].expand_as(xyz).reshape(-1, 3))
    sd = torch.where(m.valid, sigma.reshape(N, S) * m.dts, 0.0)
    cum = torch.cumsum(sd, dim=-1)
    T_before = torch.exp(-(cum - sd))
    alpha = 1.0 - torch.exp(-sd)
    include = (T_before >= T_thresh).detach() & m.valid
    w = torch.where(include, alpha * T_before, 0.0)
    ws = w.sum(dim=-1)
    image = ((w[..., None] * rgb.reshape(N, S, 3)).sum(dim=1) + (1.0 - ws)[:, None] * bg)
    span = (fars - nears).clamp(min=1e-6)
    depth = torch.where(nears < 1e30, ((w * m.depth_ts).sum(-1) - nears).clamp(min=0.0) / span, 0.0)
    return {"rgb_map": image.clamp(0.0, 1.0), "weights_sum": ws, "depth_map": depth,
            "n_samples": m.valid.sum(dim=-1), "valid": m.valid.sum()}


_KDOP = torch.tensor([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, -1, 0], [1, 0, 1],
                      [1, 0, -1], [0, 1, 1], [0, 1, -1], [1, 1, 1], [1, 1, -1], [1, -1, 1],
                      [1, -1, -1]], dtype=torch.float32)


def cell_centers(H: int) -> np.ndarray:
    r = np.arange(H, dtype=np.float32)
    xx, yy, zz = np.meshgrid(r, r, r, indexing="ij")
    return 2.0 * np.stack([xx, yy, zz], -1).reshape(-1, 3) / (H - 1) - 1.0


def kdop(occ0, bound):
    """13-slab bounds of the occupied cells, each grown by a cell's
    projected extent; the training box's for an empty grid."""
    H = occ0.shape[0]
    dev = occ0.device
    mb = min(1.0, bound)
    dirs = _KDOP.to(dev)
    proj = torch.as_tensor(cell_centers(H), device=dev) * mb @ dirs.T
    occ = occ0.reshape(-1, 1)
    lo = torch.where(occ, proj, 1e30).amin(dim=0)
    hi = torch.where(occ, proj, -1e30).amax(dim=0)
    half = (2.0 * mb / H) * dirs.abs().sum(dim=-1)
    lo, hi = lo - half, hi + half
    full = make_aabb(bound, dev)
    corners = torch.stack([torch.stack([full[3 * (i % 2)], full[1 + 3 * ((i >> 1) % 2)],
                                        full[2 + 3 * ((i >> 2) % 2)]]) for i in range(8)])
    cp = corners @ dirs.T
    empty = ~occ0.any()
    return torch.where(empty, cp.amin(0), lo), torch.where(empty, cp.amax(0), hi)


def kdop_hit(o, d, box, min_near):
    lo, hi = box
    dirs = _KDOP.to(o.device)
    od, dd = o.float() @ dirs.T, d.float() @ dirs.T
    dd = torch.where(dd.abs() < 1e-12, 1e-12, dd)
    t0, t1 = (lo[None] - od) / dd, (hi[None] - od) / dd
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    return (near.clamp(min=min_near) <= far) & (far >= min_near)


def ray_capacity(n_hit: int, n_total: int):
    if n_hit <= 0:
        return None
    cap = int(-(-int(n_hit * 1.15) // 4096) * 4096)
    return cap if cap < n_total else None


def render_frame(field, o, d, occ0, box, capacity, bg, **kw):
    """The culled frame: the first ``capacity`` rays that meet the k-DOP,
    rendered over black, put back into the frame over ``bg``."""
    N = o.shape[0]
    if not capacity:
        return render_rays(field, o, d, occ0, bg=bg, **kw)
    C = min(int(capacity), N)
    hit = kdop_hit(o, d, box, kw["min_near"])
    idx = torch.full((C,), N, dtype=torch.int64, device=o.device)
    found = torch.nonzero(hit)[:C, 0]
    idx[:found.shape[0]] = found
    safe = idx.clamp(max=N - 1)
    inner = render_rays(field, o[safe], d[safe], occ0, bg=0.0, **kw)
    packed = torch.cat([inner["rgb_map"], inner["weights_sum"][:, None]], dim=-1)
    full = torch.zeros(N + 1, 4, device=o.device).index_add(0, idx, packed)[:N]
    ws = full[:, 3]
    return {"rgb_map": (full[:, :3] + (1.0 - ws)[:, None] * bg).clamp(0.0, 1.0),
            "weights_sum": ws, "valid": inner["valid"]}


# ----------------------------------------------------------------- torso ----
def sample_torso(grid, coords, H):
    g = grid.reshape(H, H)
    fx = (coords[:, 0] + 1.0) * 0.5 * (H - 1)
    fy = (coords[:, 1] + 1.0) * 0.5 * (H - 1)
    x0 = torch.floor(fx).to(torch.int64).clamp(0, H - 2)
    y0 = torch.floor(fy).to(torch.int64).clamp(0, H - 2)
    wx, wy = fx - x0, fy - y0
    return (g[y0, x0] * (1 - wx) * (1 - wy) + g[y0, x0 + 1] * wx * (1 - wy)
            + g[y0 + 1, x0] * (1 - wx) * wy + g[y0 + 1, x0 + 1] * wx * wy)


def torso_mask(density, mean, coords, H, thresh):
    return sample_torso(density, coords, H) > torch.clamp(mean, max=thresh)


def torso_composite(head, torso_out, mask, bg):
    """Head over torso over background."""
    alpha, color, _ = torso_out
    m = mask.float().reshape(-1, 1)
    ws = head["weights_sum"][:, None]
    ta = alpha * m
    torso_bg = color * m * ta + bg * (1.0 - ta)
    return {"rgb_map": (head["rgb_map"] + (1.0 - ws) * torso_bg).clamp(0.0, 1.0),
            "torso_rgb_map": torso_bg, "torso_alpha_map": ta}


def torso_sweep(alpha_fn, density, jitter, H, decay=0.95):
    half = 1.0 / H
    r = torch.arange(H, dtype=torch.float32, device=density.device)
    gx, gy = torch.meshgrid(r, r, indexing="ij")
    xy = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    xy = (2.0 * xy / (H - 1) - 1.0) * (1.0 - half) + (jitter * 2 - 1) * half
    tmp = alpha_fn(xy).float().reshape(H, H).T
    tmp = F.max_pool2d(tmp[None, None], 5, stride=1, padding=2)[0, 0]
    new = torch.maximum(density * decay, tmp.reshape(-1))
    return new, new.mean()


def head_sweep(density_fn, density, noise, H, bound, thresh, decay=0.95, chunks=16):
    """The density sweep at jittered cell centres → dilation → decayed max
    → threshold at ``min(mean density, thresh)`` (one cascade)."""
    world = torch.as_tensor(cell_centers(H), device=density.device)
    half = bound / H
    pts = world * (bound - half) + (noise[0] * 2 - 1) * half
    tmp = torch.cat([density_fn(c).float() for c in pts.chunk(chunks)])
    tmp = F.max_pool3d(tmp.reshape(1, 1, H, H, H), 3, stride=1, padding=1).reshape(1, -1)
    valid = (density >= 0) & (tmp >= 0)
    new = torch.where(valid, torch.maximum(density * decay, tmp), density)
    mean = new.clamp(min=0.0).mean()
    return new, (new > torch.clamp(mean, max=thresh)).reshape(1, H, H, H), mean


# ---------------------------------------------------------------- camera ----
def get_rays(pose, intrinsics, H, W, inds=None):
    fx, fy, cx, cy = [float(v) for v in intrinsics]
    pose = np.asarray(pose, np.float32)
    inds = np.arange(H * W) if inds is None else inds
    i = (inds % W).astype(np.float32) + 0.5
    j = (inds // W).astype(np.float32) + 0.5
    dirs = np.stack([(i - cx) / fx, (j - cy) / fy, np.ones_like(i)], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays_d = dirs @ pose[:3, :3].T
    return np.broadcast_to(pose[:3, 3], rays_d.shape).copy(), rays_d


def rays_device(pose, intrinsics, inds, W):
    fx, fy, cx, cy = [float(v) for v in intrinsics]
    i = (inds % W).float() + 0.5
    j = torch.div(inds, W, rounding_mode="floor").float() + 0.5
    dirs = torch.stack([(i - cx) / fx, (j - cy) / fy, torch.ones_like(i)], dim=-1)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    rays_d = dirs @ pose[:3, :3].T
    return pose[:3, 3].expand_as(rays_d), rays_d, i, j


def ngp_pose(p, scale=4.0):
    p = np.asarray(p, np.float32)
    return np.array([[p[1, 0], -p[1, 1], -p[1, 2], p[1, 3] * scale],
                     [p[2, 0], -p[2, 1], -p[2, 2], p[2, 3] * scale],
                     [p[0, 0], -p[0, 1], -p[0, 2], p[0, 3] * scale],
                     [0, 0, 0, 1]], dtype=np.float32)


def pose6(p):
    m = np.asarray(p, np.float32)[None]
    b = np.arcsin(np.clip(m[:, 0, 2], -1.0, 1.0))
    a = np.arctan2(-m[:, 1, 2], m[:, 2, 2])
    c = np.arctan2(-m[:, 0, 1], m[:, 0, 0])
    return np.concatenate([np.stack([a, b, c], -1), m[:, :3, 3]], -1).astype(np.float32)


def smooth_path(poses, kernel_size=7):
    from scipy.spatial.transform import Rotation

    poses = poses.copy()
    N, K = poses.shape[0], kernel_size // 2
    trans, rots = poses[:, :3, 3].copy(), poses[:, :3, :3].copy()
    for i in range(N):
        lo, hi = max(0, i - K), min(N, i + K + 1)
        poses[i, :3, 3] = trans[lo:hi].mean(0)
        poses[i, :3, :3] = Rotation.from_matrix(rots[lo:hi]).mean().as_matrix()
    return poses


def cond_window(conds, idx, size, edge=False):
    left = idx - size // 2
    right = idx + (size - size // 2)
    pl, pr = max(0, -left), max(0, right - len(conds))
    win = conds[max(0, left):min(len(conds), right)]
    if pl or pr:
        if edge:
            win = np.concatenate([np.repeat(win[:1], pl, 0), win, np.repeat(win[-1:], pr, 0)])
        else:
            win = np.pad(win, [(pl, pr)] + [(0, 0)] * (win.ndim - 1))
    return win


_REGIONS = {"jaw": slice(0, 17), "brow": slice(17, 27), "nose": slice(27, 36),
            "eye": slice(36, 48), "mouth": slice(48, 68)}


def conds_from_lm3d(lm3d, mean, std, clamp_std=2.5, win=1):
    """Raw lm3d ``[T, 68, 3]`` → normalised, clamped per region, causal
    EMA (0.2), windows of ``win`` frames."""
    lm = (lm3d.reshape(-1, 68, 3) - mean) / std
    for name in ("jaw", "nose", "mouth"):
        lm[:, _REGIONS[name]] = np.clip(lm[:, _REGIONS[name]], -clamp_std, clamp_std)
    for name in ("brow", "eye"):
        sl = _REGIONS[name]
        lm[:, sl, 0:2] = np.clip(lm[:, sl, 0:2], -clamp_std / 2, clamp_std / 2)
        lm[:, sl, 2] = np.clip(lm[:, sl, 2], -clamp_std, clamp_std)
    moving = lm[0].copy()
    for i in range(len(lm)):
        for sl in _REGIONS.values():
            lm[i, sl] = 0.2 * moving[sl] + 0.8 * lm[i, sl]
        moving = lm[i].copy()
    flat = lm.reshape(-1, 204).astype(np.float32)
    return np.stack([cond_window(flat, i, win, edge=True) for i in range(len(flat))])


# ------------------------------------------------------------------ Adam ----
class Adam:
    """Adam over named groups with a shared exponential schedule times a
    per-group multiplier; eps 1e-15 outside the root; bias-corrected."""

    def __init__(self, groups: dict, lr: float, b1=0.9, b2=0.999, eps=1e-15,
                 decay_steps=250_000):
        self.groups = groups  # name -> (mult, {param name: tensor})
        self.lr, self.b1, self.b2, self.eps, self.decay = lr, b1, b2, eps, decay_steps
        self.count = 0
        self.mu = {n: torch.zeros_like(p) for _, ps in groups.values() for n, p in ps.items()}
        self.nu = {n: torch.zeros_like(p) for n in self.mu for p in [self.mu[n]]}

    @torch.no_grad()
    def step(self, grads: dict):
        c = torch.tensor(float(self.count))
        lr = float(torch.clamp(self.lr * torch.pow(torch.tensor(0.1), c / self.decay), min=1e-7))
        bc1 = 1.0 - self.b1 ** (self.count + 1)
        bc2 = 1.0 - self.b2 ** (self.count + 1)
        for mult, ps in self.groups.values():
            for n, p in ps.items():
                g = grads.get(n)
                g = torch.zeros_like(p) if g is None else g
                self.mu[n] = (1.0 - self.b1) * g + self.b1 * self.mu[n]
                self.nu[n] = (1.0 - self.b2) * (g * g) + self.b2 * self.nu[n]
                p.add_(-(lr * mult) * ((self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + self.eps)))
        self.count += 1
