"""Row scatter-add ``out[r] = Σ_{i: rows[i]=r} updates[i]`` — the wrapper
of the CUDA kernel ``csrc/scatter_add_rows.cu`` (the port of the Pallas
kernel ``geneface_tpu/ops/pallas_scatter.py:79``).

Semantics of ``geneface_tpu/ops/scatter.py``: out-of-range rows, negative
ones included, are dropped, and updates accumulate in float32 whatever
their dtype. On the render path it computes the composite's per-ray sums
(rows = the ray of each compact sample) and the scatter of the culled rays
back to the frame (unique rows, so exact).

A CPU tensor runs :func:`scatter_add_rows_plain`; a CUDA tensor launches the
kernel or raises. ``LAUNCHES`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["scatter_add_rows", "scatter_add_rows_plain", "LAUNCHES"]

#: kernel name -> launches so far (reset by callers that count a run)
LAUNCHES = {"scatter_add_rows": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def scatter_add_rows_plain(
    rows: torch.Tensor, updates: torch.Tensor, n_rows: int
) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` of the in-range rows."""
    keep = (rows >= 0) & (rows < n_rows)
    out = torch.zeros(n_rows, updates.shape[-1], dtype=torch.float32, device=updates.device)
    return out.index_add_(0, rows[keep].long(), updates[keep].float())


def _check(rows: torch.Tensor, updates: torch.Tensor, n_rows: int) -> None:
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


def scatter_add_rows(
    rows: torch.Tensor,  # [M] int32 destination row per update (OOB dropped)
    updates: torch.Tensor,  # [M, W] float32 / bfloat16 / float16
    n_rows: int,
) -> torch.Tensor:
    """``[n_rows, W]`` float32 row sums of ``updates`` grouped by ``rows``."""
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
