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

K1 has five kernel variants (``VARIANTS``; the source's header says what
bounds each). :func:`pick_scatter_variant` chooses one from the call's
shape and alignment, and from the caller's word that its rows spread
evenly over the table (``spread``: the torso grid's); every variant is right for every input it
accepts, so the choice moves time, never the result beyond the order of
float32 sums. ``launch_scatter_add_rows(..., variant="runs")`` forces one,
for measurements and card tests; nothing on the model's path passes it.
"""

from __future__ import annotations

import ctypes

import torch
from torch._C._profiler import _RecordFunctionFast

from geneface_tpu_torch.kernels import LAUNCHES
from geneface_tpu_torch.ops.gather import gather_rows_plain, launch_gather_rows

__all__ = [
    "scatter_add_rows",
    "scatter_add_rows_plain",
    "launch_scatter_add_rows",
    "pick_scatter_variant",
    "scatter_variant_accepts",
    "smem_plan",
    "VARIANTS",
    "SMEM_LIMIT",
    "gather_rows",
    "gather_rows_plain",
    "launch_gather_rows",
    "LAUNCHES",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: the kernel variants of ``csrc/scatter_add_rows.cu``
VARIANTS = ("atomic", "smem", "runs", "vec", "sorted")
#: the most dynamic shared memory a block can use on Hopper, in bytes
SMEM_LIMIT = 232448
#: threads of a block of the ``smem`` variant (``kSmemThreads`` in the source)
SMEM_THREADS = 1024
#: streaming multiprocessors of an H100 SXM: the most blocks the ``smem``
#: variant launches, one per SM (the launcher reads the card's own count)
H100_SMS = 132
#: ``sorted`` is chosen for rows wider than this: a warp then holds one
#: update or less, so ``vec`` finds no neighbouring rows to merge
SORTED_MIN_WIDTH = 33
#: ``sorted`` is chosen from this many bytes of updates on: its sort costs
#: ~25 µs on an H100 whatever the width, its sums then run near the bytes
#: bound, where ``vec`` takes about twice the bound
SORTED_MIN_UPDATE_BYTES = 1 << 26
#: threads of a block of the ``sorted`` variant's counting kernels
SORT_THREADS = 1024
#: row widths the ``runs`` variant is compiled for
RUNS_WIDTHS = (2, 6)
#: ``vec`` is chosen from this many updates on: its walk gives a warp 32
#: updates and a lane group walks up to 32 of them in series, so a smaller
#: call (fewer warps than SMs) waits on that walk, where ``atomic`` spreads
#: one atomic per element over the card (stage A's mouth clip adjoint,
#: 320 updates of 60 columns: ``atomic`` 0.0030 ms, ``vec`` 0.0053 on an
#: H100 80GB HBM3 at 700 W)
VEC_MIN_UPDATES = 4096


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


def scatter_variant_accepts(
    variant: str, M: int, W: int, n_rows: int, itemsize: int, aligned: bool
) -> bool:
    """Whether ``variant`` takes ``[M, W]`` updates of ``itemsize`` bytes per
    value into ``[n_rows, W]``; ``aligned`` says that the updates start on a
    16-byte boundary (the vector loads)."""
    if variant == "atomic":
        return True
    if variant == "smem":
        # scalar loads where the vectors do not fit, so any alignment; one
        # thread of a block per column
        return 0 < n_rows * W * 4 <= SMEM_LIMIT and W <= SMEM_THREADS
    if variant == "runs":
        return aligned and W in RUNS_WIDTHS
    if variant == "vec":
        return aligned and W > 0 and W % 2 == 0
    if variant == "sorted":
        # one int per table row in a block's shared memory
        return aligned and W > 0 and W % 2 == 0 and M < 2**31 and 0 < n_rows * 4 <= SMEM_LIMIT
    raise ValueError(f"unknown scatter variant {variant!r}; one of {VARIANTS}")


def pick_scatter_variant(M: int, W: int, n_rows: int, itemsize: int, aligned: bool,
                         spread: bool = False) -> str:
    """The variant of ``csrc/scatter_add_rows.cu`` for a call's shape.

    - odd ``W``, unaligned updates or nothing to add: ``atomic``, which
      takes anything;
    - a table that fits a block's shared memory and gets at least one
      update per row for each block that flushes it: ``smem`` (each block of
      :func:`smem_plan`'s grid — one per SM for a large call, fewer for a
      small one — flushes the whole table once, so it pays only where the
      updates outnumber ``blocks * n_rows``; measured on the H100 at the
      lip step's ambient coarse group, ``[32768, 16]`` into 324 rows from
      32 blocks, ``smem`` took 0.0099 ms and ``vec`` 0.0168); not where the
      caller says its rows are ``spread`` evenly over the table, where
      ``vec``'s vector atomics rarely collide and ``smem``'s shared-memory
      compare-and-swap loops cost more (the torso step's coarse group of
      the torso grid, the same ``[65536, 16]`` into 324 rows per block
      count: ``smem`` 0.0091–0.0092 ms, ``vec`` 0.0071–0.0085 over three
      calls on the H100 80GB HBM3 at 700 W; the shape cannot tell the two
      apart);
    - narrow rows (``W`` 2 or 6): ``runs``, which merges equal neighbouring
      rows in the warp and costs nothing where there are none;
    - rows of at least ``SORTED_MIN_WIDTH`` columns with at least
      ``SORTED_MIN_UPDATE_BYTES`` of updates and a table of at most 58,112
      rows: ``sorted``;
    - any other even ``W`` with at least ``VEC_MIN_UPDATES`` updates:
      ``vec`` (16-byte vector atomics where ``W % 4 == 0``, 8-byte ones
      else), which merges equal neighbouring rows in registers; fewer
      updates take ``atomic``.
    """
    if not aligned or W % 2 or M == 0 or W == 0 or n_rows == 0:
        return "atomic"
    if not spread and scatter_variant_accepts("smem", M, W, n_rows, itemsize, aligned):
        blocks = smem_plan(M, W, n_rows, 4 if W % 4 == 0 else 2, H100_SMS)[0]
        if M >= blocks * n_rows:
            return "smem"
    if W in RUNS_WIDTHS:
        return "runs"
    if (W >= SORTED_MIN_WIDTH and M * W * itemsize >= SORTED_MIN_UPDATE_BYTES
            and scatter_variant_accepts("sorted", M, W, n_rows, itemsize, aligned)):
        return "sorted"
    return "vec" if M >= VEC_MIN_UPDATES else "atomic"


def smem_plan(M: int, W: int, n_rows: int, vec_width: int, sm_count: int) -> tuple:
    """``(blocks, copies, copy_stride)`` of the ``smem`` variant: a
    persistent grid of at most one block per SM; as many accumulator copies
    (a power of two, at most 8) as the shared memory holds, each starting
    one bank after the last (``copy_stride % 32 == 1``), or one unpadded
    copy."""
    elems = n_rows * W
    stride = elems + (1 - elems) % 32
    copies = 8
    while copies > 1 and copies * stride * 4 > SMEM_LIMIT:
        copies //= 2
    if copies == 1:
        stride = elems
    pairs = M * (W // vec_width)  # one thread takes a few (update, vector) pairs
    blocks = max(1, min(sm_count, -(-pairs // (4 * SMEM_THREADS))))
    return blocks, copies, stride


def _bind(lib, name: str, n_extra_ints: int, scratch: bool = False):
    """``lib.<name>`` with the argument types of (rows, updates, out,
    [scratch,] M, W, n_rows, dtype, n_extra_ints ints, stream)."""
    fn = getattr(lib, name)
    fn.argtypes = (
        [ctypes.c_void_p] * (4 if scratch else 3) + [ctypes.c_int64] * 3
        + [ctypes.c_int] * (1 + n_extra_ints) + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def launch_scatter_add_rows(
    rows: torch.Tensor,  # [M] int32 destination row per update (OOB dropped)
    updates: torch.Tensor,  # [M, W] float32 / bfloat16 / float16
    n_rows: int,
    variant: str | None = None,
    spread: bool = False,
) -> torch.Tensor:
    """``[n_rows, W]`` float32 row sums of ``updates`` grouped by ``rows``
    (not differentiable: see :func:`scatter_add_rows`).

    On the card the kernel variant is :func:`pick_scatter_variant`'s choice
    for the shape (and ``spread``); ``variant`` forces one (for measurements and tests; a
    variant that does not take the shape raises ``ValueError``). One call
    counts as one launch whatever the variant."""
    # a host range of the profiler's operator scope, not a user annotation: the
    # profiler gives each kernel to the innermost user annotation alone, so a
    # record_function here would take the kernels from a caller's span
    with _RecordFunctionFast("gf::k1"):
        _check(rows, updates, n_rows)
        M, W = updates.shape
        n_rows = int(n_rows)
        itemsize = updates.element_size()
        aligned = updates.data_ptr() % 16 == 0
        if variant is None:
            variant = pick_scatter_variant(M, W, n_rows, itemsize, aligned, spread)
        elif not scatter_variant_accepts(variant, M, W, n_rows, itemsize, aligned):
            raise ValueError(
                f"scatter variant {variant!r} does not take updates [{M}, {W}] "
                f"({'aligned' if aligned else 'unaligned'}) into [{n_rows}, {W}]"
            )
        if updates.device.type == "cpu":
            return scatter_add_rows_plain(rows, updates, n_rows)
        if updates.device.type != "cuda":
            raise ValueError(f"unsupported device {updates.device}")
        from geneface_tpu_torch.kernels import load_kernel

        lib = load_kernel("scatter_add_rows")
        dev = updates.device
        head = (rows.data_ptr(), updates.data_ptr())
        tail = (M, W, n_rows, _DTYPE_CODES[updates.dtype])
        vec_width = 4 if W % 4 == 0 else 2  # columns per vector load and atomic
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            if variant == "smem" and M > 0 and W > 0:
                V = vec_width if aligned and W % 2 == 0 else 1
                sms = torch.cuda.get_device_properties(dev).multi_processor_count
                blocks, copies, stride = smem_plan(M, W, n_rows, V, sms)
                # the second kernel writes every output element: no zero fill
                out = torch.empty(n_rows, W, dtype=torch.float32, device=dev)
                scratch = torch.empty(blocks * n_rows * W, dtype=torch.float32, device=dev)
                rc = _bind(lib, "gf_scatter_add_rows_smem", 4, scratch=True)(
                    *head, out.data_ptr(), scratch.data_ptr(), *tail, V, blocks, copies,
                    stride, stream,
                )
            else:
                out = torch.zeros(n_rows, W, dtype=torch.float32, device=dev)
                if variant == "vec":
                    rc = _bind(lib, "gf_scatter_add_rows_vec", 1)(
                        *head, out.data_ptr(), *tail, vec_width, stream)
                elif variant == "sorted":
                    sms = torch.cuda.get_device_properties(dev).multi_processor_count
                    # an even number of blocks keeps the (index, row) pairs behind
                    # their row counts 8-byte aligned
                    blocks = 2 * max(1, min(sms // 2, -(-M // (2 * SORT_THREADS))))
                    scratch = torch.empty(
                        n_rows * blocks + n_rows + 2 + 2 * M, dtype=torch.int32, device=dev)
                    rc = _bind(lib, "gf_scatter_add_rows_sorted", 2, scratch=True)(
                        *head, out.data_ptr(), scratch.data_ptr(), *tail, vec_width, blocks,
                        stream,
                    )
                elif variant == "runs":
                    rc = _bind(lib, "gf_scatter_add_rows_runs", 0)(
                        *head, out.data_ptr(), *tail, stream)
                else:
                    rc = _bind(lib, "gf_scatter_add_rows", 0)(
                        *head, out.data_ptr(), *tail, stream)
        if rc != 0:
            raise RuntimeError(
                f"scatter_add_rows kernel ({variant}) launch failed: cudaError {rc}")
        LAUNCHES["scatter_add_rows"] += 1
        return out


class _ScatterAddRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, updates, n_rows, site):
        ctx.save_for_backward(rows)
        ctx.updates_dtype = updates.dtype
        ctx.site = site
        return launch_scatter_add_rows(rows, updates, n_rows)

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        if not ctx.needs_input_grad[1]:
            return None, None, None, None
        # dropped rows (out of range) read a zero row
        gu = gather_rows(g.contiguous(), rows, ctx.site)
        return None, gu.to(ctx.updates_dtype), None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, site):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        ctx.table_dtype = table.dtype
        ctx.site = site
        return launch_gather_rows(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None
        gt = scatter_add_rows(idx, g.contiguous(), ctx.n_rows, ctx.site)
        return gt.to(ctx.table_dtype), None, None


def scatter_add_rows(
    rows: torch.Tensor, updates: torch.Tensor, n_rows: int, site=None
) -> torch.Tensor:
    """Differentiable :func:`launch_scatter_add_rows`; the gradient of
    ``updates`` is :func:`gather_rows` of the output gradient at ``rows``.
    ``site`` labels the call (and its backward's) for measurements; it
    changes nothing else."""
    return _ScatterAddRows.apply(rows, updates, int(n_rows), site)


def gather_rows(table: torch.Tensor, idx: torch.Tensor, site=None) -> torch.Tensor:
    """Differentiable :func:`launch_gather_rows`; the gradient of ``table``
    is :func:`scatter_add_rows` of the output gradient at ``idx``. ``site``
    labels the call (and its backward's) for measurements."""
    return _GatherRows.apply(table, idx, site)
