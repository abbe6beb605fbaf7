"""Sample compaction: pack the valid march samples ray-major into a fixed
capacity (port of ``geneface_tpu/ops/compaction.py``).

March samples are prefix-contiguous per ray (slot k of ray i is valid iff
``k < n_i``), so compaction is an exclusive scan of ``n`` plus a gather.
Under capacity pressure :func:`waterfill_valid` drops the deepest samples
uniformly across rays first.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

__all__ = [
    "CompactPlan",
    "waterfill_valid",
    "make_compact_plan",
    "compact_gather",
    "segmented_cumsum",
]


class CompactPlan(NamedTuple):
    ray: torch.Tensor  # [Mc] int64 ray of each compact slot
    src: torch.Tensor  # [Mc] int64 flat (ray*S + slot) source index
    valid: torch.Tensor  # [Mc] bool: slot holds a real sample
    total: torch.Tensor  # [] number of real samples (may exceed Mc)
    offset: torch.Tensor  # [N] exclusive-cumsum segment starts
    n: torch.Tensor  # [N] samples per ray
    is_start: torch.Tensor  # [Mc] bool: first slot of its segment


def waterfill_valid(valid: torch.Tensor, capacity: int, group=None) -> torch.Tensor:
    """Fit a prefix-dense ``[N, S]`` mask into ``capacity`` slots: grant every
    ray up to the largest level ``q*`` with ``sum_i min(n_i, q*) <= capacity``
    plus one partial level to the first remaining rays. Unchanged when
    ``capacity >= total``; the result stays prefix-dense.

    With a process ``group`` the ranks' masks are the row blocks of one
    global mask, in rank order, and ``capacity`` is the global budget: the
    level counts are all-reduced (one ``q*`` for all rays) and each rank's
    partial-level ranks start after the lower ranks' (an all-reduce of one
    slot per rank), so every rank keeps its rows of the whole mask's
    waterfill, as under XLA's SPMD partitioning of the JAX function. One
    rank gives the function without a group."""
    N, S = valid.shape
    level_counts = valid.sum(dim=0)  # [S] rays with a sample at each slot
    if group is not None:
        dist.all_reduce(level_counts, group=group)
    summin = torch.cumsum(level_counts, dim=0)  # summin[q-1] = sum_i min(n_i, q)
    qstar = (summin <= capacity).sum()
    base = torch.where(qstar > 0, summin[(qstar - 1).clamp(min=0)], 0)
    rem = (capacity - base).clamp(min=0)
    has_extra = valid[:, qstar.clamp(max=S - 1)] & (qstar < S)
    rank_of_extra = torch.cumsum(has_extra.to(torch.int64), dim=0)
    if group is not None:
        slots = torch.zeros(dist.get_world_size(group), dtype=torch.int64, device=valid.device)
        r = dist.get_rank(group)
        slots[r] = has_extra.sum()
        dist.all_reduce(slots, group=group)
        rank_of_extra = rank_of_extra + slots[:r].sum()
    extra = has_extra & (rank_of_extra <= rem)
    slot = torch.arange(S, device=valid.device)[None, :]
    keep = (slot < qstar) | ((slot == qstar) & extra[:, None])
    return valid & keep


def make_compact_plan(valid: torch.Tensor, capacity: int) -> CompactPlan:
    """Compaction index map of a prefix-dense ``[N, S]`` mask."""
    N, S = valid.shape
    dev = valid.device
    n = valid.sum(dim=-1)
    csum = torch.cumsum(n, dim=0)
    offset = csum - n
    total = csum[-1]
    # ray id per slot: count of segment starts at or before it. Zero-length
    # rays share an offset with their successor; the last one wins, which is
    # the ray that owns the samples.
    starts = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    starts.index_add_(0, offset.clamp(max=capacity), torch.ones_like(offset))
    ray = torch.cumsum(starts[:capacity], dim=0) - 1
    j = torch.arange(capacity, device=dev)
    valid_c = j < torch.clamp(total, max=capacity)
    slot_in_ray = j - offset[ray.clamp(min=0)]
    src = torch.where(valid_c, ray * S + slot_in_ray, 0)
    return CompactPlan(
        ray=ray, src=src, valid=valid_c, total=total, offset=offset, n=n,
        is_start=slot_in_ray == 0,
    )


def compact_gather(plan: CompactPlan, slab: torch.Tensor) -> torch.Tensor:
    """Gather ``[N, S, ...]`` slab values to ``[Mc, ...]`` (0 at invalid slots)."""
    flat = slab.reshape((slab.shape[0] * slab.shape[1],) + slab.shape[2:])
    out = flat[plan.src]
    mask = plan.valid.reshape((-1,) + (1,) * (out.ndim - 1))
    return torch.where(mask, out, 0)


def segmented_cumsum(values: torch.Tensor, is_start: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over ``[M, ...]`` that restarts at segment starts.

    A global cumsum followed by base subtraction would cancel
    catastrophically in float32 (the running sum over ~1M slots dwarfs the
    per-segment partials), so every partial stays segment-local: the
    Hillis-Steele scan with the segmented operator
    ``(fa, va) ⊕ (fb, vb) = (fa|fb, vb + (fb ? 0 : va))``, log2(M) shifted
    passes. (The JAX reference blocks this scan only to keep its TPU
    compile time down.)
    """
    M = values.shape[0]
    tail = (1,) * (values.ndim - 1)
    v = values
    f = is_start.to(torch.bool)
    k = 1
    while k < M:
        va = torch.cat([torch.zeros_like(v[:k]), v[:-k]])
        fa = torch.cat([torch.zeros_like(f[:k]), f[:-k]])
        v = v + torch.where(f.reshape((-1,) + tail), 0.0, va)
        f = f | fa
        k *= 2
    return v
