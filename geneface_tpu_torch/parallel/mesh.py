"""Data parallelism over ranks (port of ``geneface_tpu/parallel/mesh.py``).

The reference trained with single-node DDP (SURVEY §2.9); the JAX package
shards the ray, frame or clip axis of a batch over the ``data`` axis of a
``jax.sharding.Mesh`` and lets XLA emit the gradient all-reduce. The port
runs one process per device under ``torch.distributed``:

- :func:`initialize_distributed` joins the process group from torchrun's
  environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``) and returns the rank's device;
- :func:`make_mesh` is a ``DeviceMesh`` with dims ``("data", "model")``;
  nothing shards over ``model``, as in the JAX package;
- :func:`shard_batch` gives each rank its rows of the leaves whose ``axis``
  divides by the data size and keeps the rest whole, so every rank starts
  from the same global batch (:func:`put_sharded`'s invariant, checked
  under ``GF_CHECK_GLOBAL_BATCH=1``).

Collectives are ``all_reduce`` and ``broadcast`` only, which gloo (also on
CUDA tensors) and NCCL both have: a gather is an all-reduce of a
zero-filled buffer in which each rank writes its own slot
(:func:`all_gather_slots`).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "initialize_distributed",
    "make_mesh",
    "world_size",
    "rank",
    "data_size",
    "data_rank",
    "local_rows",
    "shard_batch",
    "put_sharded",
    "global_batch_checksum",
    "host_local_slice",
    "all_gather_slots",
    "all_gather_rows",
    "barrier",
    "broadcast_tensors",
]

DATA_AXIS = "data"
MODEL_AXIS = "model"

#: torchrun's variables; without ``WORLD_SIZE`` a process runs alone
_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def initialize_distributed(device: str | torch.device | None = None) -> torch.device | None:
    """Join the process group described by torchrun's environment and
    return this rank's device: ``device`` when given, else
    ``cuda:LOCAL_RANK``. Without ``WORLD_SIZE`` in the environment it does
    nothing and returns ``device`` (the caller's default then applies).

    The backend is ``gloo`` for a CPU device or under
    ``GF_DIST_BACKEND=gloo`` (two ranks sharing one card), else ``nccl``.
    A CUDA device that does not exist raises."""
    if "WORLD_SIZE" not in os.environ:
        return None if device is None else torch.device(device)
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"incomplete torchrun environment: {missing} not set")
    world = int(os.environ["WORLD_SIZE"])
    rank_ = int(os.environ["RANK"])
    dev = torch.device(device if device is not None else f"cuda:{int(os.environ['LOCAL_RANK'])}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA rank device needs torch.cuda.is_available()")
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank_} asks for {dev} but the host has "
                f"{torch.cuda.device_count()} card(s)")
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    backend = "gloo" if dev.type == "cpu" or os.environ.get("GF_DIST_BACKEND") == "gloo" else "nccl"
    if not dist.is_initialized():
        dist.init_process_group(
            backend,
            init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
            world_size=world, rank=rank_,
        )
    return dev


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_mesh(n_data: int | None = None, n_model: int = 1):
    """A ``(data, model)`` ``DeviceMesh`` over every rank of the process
    group: a ``cuda`` mesh under NCCL, a ``cpu`` one under gloo (gloo's
    collectives take CUDA tensors all the same)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_distributed first")
    n = dist.get_world_size()
    if n_data is None:
        n_data = n // n_model
    if n_data * n_model != n:
        raise ValueError(f"mesh {n_data}x{n_model} != {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def _data_group(mesh):
    return None if mesh is None else mesh.get_group(DATA_AXIS)


def _comm_device(mesh) -> torch.device:
    """Where a buffer the caller makes for a collective lives: the current
    card under NCCL, else the host."""
    if dist.get_backend(_data_group(mesh)) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def data_size(mesh) -> int:
    return 1 if mesh is None else mesh.size(0)


def data_rank(mesh) -> int:
    return 0 if mesh is None else mesh.get_local_rank(DATA_AXIS)


def _splits(x, mesh, axis: int) -> bool:
    return x.ndim > axis and x.shape[axis] % data_size(mesh) == 0


def local_rows(mesh, x, axis: int = 0):
    """This rank's contiguous block of ``x`` along ``axis`` (numpy array or
    tensor) when that axis divides by the data size, else ``x`` whole."""
    if mesh is None or not _splits(x, mesh, axis):
        return x
    per = x.shape[axis] // data_size(mesh)
    lo = data_rank(mesh) * per
    index = (slice(None),) * axis + (slice(lo, lo + per),)
    return x[index]


def global_batch_checksum(x) -> float:
    """The float64 sum the JAX ``put_sharded`` check compares across hosts
    (0 for a non-numeric leaf)."""
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if not np.issubdtype(a.dtype, np.number):
        return 0.0
    return float(np.asarray(a, np.float64).sum())


def put_sharded(mesh, x, split: bool, axis: int = 0):
    """One leaf of the global batch → this rank's rows (``split``) or the
    leaf whole. Every rank must pass the bit-identical global ``x``; under
    ``GF_CHECK_GLOBAL_BATCH=1`` an all-reduced checksum asserts it."""
    if mesh is None:
        return x
    if os.environ.get("GF_CHECK_GLOBAL_BATCH") and hasattr(x, "ndim"):
        mine = global_batch_checksum(x)
        sums = all_gather_slots(mesh, torch.tensor([mine], dtype=torch.float64,
                                                    device=_comm_device(mesh)))
        if not bool(torch.all(sums == sums[0])):
            raise AssertionError(
                f"global-batch invariant violated: per-rank checksums {sums.tolist()}")
    return local_rows(mesh, x, axis) if split else x


def shard_batch(mesh, batch: dict, axis: int = 0) -> dict:
    """Every array leaf of ``batch`` whose ``axis`` divides by the data
    size → this rank's rows; scalars, low-rank and non-divisible leaves are
    kept whole (replicated)."""
    out = {}
    for k, v in batch.items():
        if hasattr(v, "ndim"):
            out[k] = put_sharded(mesh, v, _splits(v, mesh, axis), axis)
        else:
            out[k] = v
    return out


def host_local_slice(global_len: int, mesh=None) -> slice:
    """The slice of a globally indexed dataset this rank feeds."""
    n = data_size(mesh) if mesh is not None else world_size()
    i = data_rank(mesh) if mesh is not None else rank()
    per = global_len // n
    return slice(i * per, (i + 1) * per)


def all_gather_slots(mesh, x: torch.Tensor) -> torch.Tensor:
    """``[data size, *x.shape]`` of every rank's ``x`` (same shape and
    dtype on every rank): an all-reduce of a zero-filled buffer in which
    each rank writes its slot. Sums with zeros are exact."""
    if mesh is None:
        return x[None]
    buf = torch.zeros((data_size(mesh),) + tuple(x.shape), dtype=x.dtype, device=x.device)
    buf[data_rank(mesh)] = x
    dist.all_reduce(buf, group=_data_group(mesh))
    return buf


class _GatherRows(torch.autograd.Function):
    """Rows of every rank, concatenated in rank order, with a gradient:
    every rank computes the same loss of the gathered rows, so the backward
    returns this rank's slot of the (identical) incoming gradient times the
    data size, which the gradient average then divides back out."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        ctx.n = x.shape[0]
        g = all_gather_slots(mesh, x.detach())
        return g.reshape((-1,) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, grad):
        r = data_rank(ctx.mesh)
        part = grad[r * ctx.n:(r + 1) * ctx.n]
        return part * data_size(ctx.mesh), None


def all_gather_rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """Concatenate every rank's rows of ``x`` along axis 0 (differentiable;
    see :class:`_GatherRows`). Without a mesh, ``x`` itself."""
    if mesh is None:
        return x
    return _GatherRows.apply(x, mesh)


def barrier(mesh) -> None:
    """Wait for every rank (a one-element all-reduce)."""
    if mesh is not None:
        dist.all_reduce(torch.zeros(1, device=_comm_device(mesh)), group=_data_group(mesh))


def broadcast_tensors(mesh, tensors: Sequence[torch.Tensor]) -> None:
    """Overwrite every tensor in place with data rank 0's copy."""
    if mesh is None:
        return
    group = _data_group(mesh)
    src = dist.get_global_rank(group, 0)
    for t in tensors:
        # gloo has no bool collectives: a bool tensor travels as its bytes
        dist.broadcast(t.view(torch.uint8) if t.dtype == torch.bool else t, src=src, group=group)
