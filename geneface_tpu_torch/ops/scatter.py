"""Row scatter-add ``out[r] = Σ_{i: rows[i]=r} updates[i]`` — the wrapper of
the CUDA kernel ``csrc/scatter_add_rows.cu`` (K1, the port of the Pallas
kernel ``geneface_tpu/ops/pallas_scatter.py:79``) — and the autograd pair of
K1 and the row gather K8.

Semantics of ``geneface_tpu/ops/scatter.py``: out-of-range rows, negative
ones included, are dropped, and updates accumulate in float32 whatever
their dtype. On the render path it computes the composite's per-ray sums
(rows = the ray of each compact sample) and the scatter of the culled rays
back to the frame (unique rows, so exact); the grid backward scatters its
table gradients through :func:`launch_scatter_add_rows` directly.

The two differentiable wrappers are each other's adjoint:
:func:`scatter_add_rows` (forward K1, backward K8 of the output gradient at
``rows``, zero at dropped rows) and :func:`gather_rows` (forward K8,
backward K1 into ``[R, W]``). A CPU tensor runs the plain versions; a CUDA
tensor launches the kernels or raises. ``LAUNCHES`` counts kernel launches
only.
"""

from __future__ import annotations

import ctypes

import torch

from geneface_tpu_torch.kernels import LAUNCHES
from geneface_tpu_torch.ops.gather import gather_rows_plain, launch_gather_rows

__all__ = [
    "scatter_add_rows",
    "scatter_add_rows_plain",
    "launch_scatter_add_rows",
    "gather_rows",
    "gather_rows_plain",
    "launch_gather_rows",
    "LAUNCHES",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def scatter_add_rows_plain(
    rows: torch.Tensor, updates: torch.Tensor, n_rows: int
) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` of the in-range rows."""
    keep = (rows >= 0) & (rows < n_rows)
    out = torch.zeros(n_rows, updates.shape[-1], dtype=torch.float32, device=updates.device)
    return out.index_add_(0, rows[keep].long(), updates[keep].float())


def _check(rows: torch.Tensor, updates: torch.Tensor, n_rows: int) -> None:
    """What the kernel takes, checked on every device, so that the CPU
    tests refuse what the card would."""
    if rows.dtype != torch.int32:
        raise TypeError(f"rows must be int32, got {rows.dtype}")
    if updates.dtype not in _DTYPE_CODES:
        raise TypeError(f"updates must be float32/bfloat16/float16, got {updates.dtype}")
    if rows.ndim != 1 or updates.ndim != 2 or updates.shape[0] != rows.shape[0]:
        raise ValueError(
            f"expected rows [M] and updates [M, W], got {tuple(rows.shape)} "
            f"and {tuple(updates.shape)}"
        )
    if rows.device != updates.device:
        raise ValueError(f"rows on {rows.device} but updates on {updates.device}")
    if not (rows.is_contiguous() and updates.is_contiguous()):
        raise ValueError("rows and updates must be contiguous")
    if int(n_rows) < 0:
        raise ValueError(f"n_rows must be >= 0, got {n_rows}")


def launch_scatter_add_rows(
    rows: torch.Tensor,  # [M] int32 destination row per update (OOB dropped)
    updates: torch.Tensor,  # [M, W] float32 / bfloat16 / float16
    n_rows: int,
) -> torch.Tensor:
    """``[n_rows, W]`` float32 row sums of ``updates`` grouped by ``rows``
    (not differentiable: see :func:`scatter_add_rows`)."""
    _check(rows, updates, n_rows)
    if updates.device.type == "cpu":
        return scatter_add_rows_plain(rows, updates, n_rows)
    if updates.device.type != "cuda":
        raise ValueError(f"unsupported device {updates.device}")
    from geneface_tpu_torch.kernels import load_kernel

    lib = load_kernel("scatter_add_rows")
    fn = lib.gf_scatter_add_rows
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    M, W = updates.shape
    out = torch.zeros(int(n_rows), W, dtype=torch.float32, device=updates.device)
    with torch.cuda.device(updates.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            rows.data_ptr(), updates.data_ptr(), out.data_ptr(), M, W,
            int(n_rows), _DTYPE_CODES[updates.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f"scatter_add_rows kernel launch failed: cudaError {rc}")
    LAUNCHES["scatter_add_rows"] += 1
    return out


class _ScatterAddRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, updates, n_rows):
        ctx.save_for_backward(rows)
        ctx.updates_dtype = updates.dtype
        return launch_scatter_add_rows(rows, updates, n_rows)

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        if not ctx.needs_input_grad[1]:
            return None, None, None
        # dropped rows (out of range) read a zero row
        gu = gather_rows(g.contiguous(), rows)
        return None, gu.to(ctx.updates_dtype), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        ctx.table_dtype = table.dtype
        return launch_gather_rows(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None
        gt = scatter_add_rows(idx, g.contiguous(), ctx.n_rows)
        return gt.to(ctx.table_dtype), None


def scatter_add_rows(
    rows: torch.Tensor, updates: torch.Tensor, n_rows: int
) -> torch.Tensor:
    """Differentiable :func:`launch_scatter_add_rows`; the gradient of
    ``updates`` is :func:`gather_rows` of the output gradient at ``rows``."""
    return _ScatterAddRows.apply(rows, updates, int(n_rows))


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Differentiable :func:`launch_gather_rows`; the gradient of ``table``
    is :func:`scatter_add_rows` of the output gradient at ``idx``."""
    return _GatherRows.apply(table, idx)
