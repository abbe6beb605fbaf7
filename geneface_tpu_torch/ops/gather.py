"""Row gather ``out[m] = table[idx[m]]`` — the wrapper of the CUDA kernel
``csrc/gather_rows.cu`` (K8, the port of the Pallas probe
``tools/bench_pallas_scatter2.py:67``, ``pallas_gather``/``gkernel``).

It is the per-group row gather of the fused grid forward and the adjoint of
the row scatter-add: an index outside ``[0, R)``, negative ones included,
gives a zero row, as the scatter-add drops it. The output is float32 for a
float32, bfloat16 or float16 table (the cast is fused into the copy).

A CPU tensor runs :func:`gather_rows_plain`; a CUDA tensor launches the
kernel or raises. :func:`launch_gather_rows` is not differentiable: the
autograd pair lives in :mod:`geneface_tpu_torch.ops.scatter`.
"""

from __future__ import annotations

import ctypes

import torch
from torch._C._profiler import _RecordFunctionFast

from geneface_tpu_torch.kernels import LAUNCHES

__all__ = ["gather_rows_plain", "launch_gather_rows", "pick_gather_path"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``table.float()[idx]`` with out-of-range rows
    zeroed."""
    R = table.shape[0]
    keep = (idx >= 0) & (idx < R)
    out = table.float()[torch.where(keep, idx, 0).long()]
    return torch.where(keep[:, None], out, 0.0)


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    """What the kernel takes, checked on every device, so that the CPU
    tests refuse what the card would."""
    if table.dtype not in _DTYPE_CODES:
        raise TypeError(f"table must be float32/bfloat16/float16, got {table.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if idx.ndim != 1 or table.ndim != 2:
        raise ValueError(
            f"expected idx [M] and table [R, W], got {tuple(idx.shape)} and "
            f"{tuple(table.shape)}"
        )
    if idx.device != table.device:
        raise ValueError(f"idx on {idx.device} but table on {table.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")


def pick_gather_path(W: int, itemsize: int, table_ptr: int, out_ptr: int) -> int:
    """Columns per thread of the kernel's path: 4 or 2 where ``W`` is a whole
    number of such vectors and the table (``itemsize`` bytes per value) and
    the float32 output are aligned to them, else 1 (the scalar path)."""
    for vec in (4, 2):
        if W % vec == 0 and table_ptr % (vec * itemsize) == 0 and out_ptr % (vec * 4) == 0:
            return vec
    return 1


def launch_gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``[M, W]`` rows of ``table`` at ``idx`` (zero where out of range)."""
    # a host range of the profiler's operator scope, not a user annotation: the
    # profiler gives each kernel to the innermost user annotation alone, so a
    # record_function here would take the kernels from a caller's span
    with _RecordFunctionFast("gf::k8"):
        _check(table, idx)
        if table.device.type == "cpu":
            return gather_rows_plain(table, idx)
        if table.device.type != "cuda":
            raise ValueError(f"unsupported device {table.device}")
        from geneface_tpu_torch.kernels import load_kernel

        lib = load_kernel("gather_rows")
        fn = lib.gf_gather_rows
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        R, W = table.shape
        M = idx.shape[0]
        out = torch.empty(M, W, dtype=torch.float32, device=table.device)
        vec = pick_gather_path(W, table.element_size(), table.data_ptr(), out.data_ptr())
        with torch.cuda.device(table.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(
                idx.data_ptr(), table.data_ptr(), out.data_ptr(), M, W, R,
                _DTYPE_CODES[table.dtype], vec, stream,
            )
        if rc != 0:
            raise RuntimeError(f"gather_rows kernel launch failed: cudaError {rc}")
        LAUNCHES["gather_rows"] += 1
        return out
