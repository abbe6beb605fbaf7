"""Data parallelism over ranks: the process group, the ``(data, model)``
mesh and the batch split (port of ``geneface_tpu/parallel``)."""

from geneface_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    all_gather_rows,
    all_gather_slots,
    barrier,
    broadcast_tensors,
    data_rank,
    data_size,
    global_batch_checksum,
    host_local_slice,
    initialize_distributed,
    local_rows,
    make_mesh,
    put_sharded,
    rank,
    shard_batch,
    world_size,
)
