"""The port's data-parallel helpers (``geneface_tpu_torch/parallel``) on two
gloo ranks on the CPU (``tests/torch_ddp_helpers.py``) against the JAX
package's ``geneface_tpu/parallel`` on the conftest's 8 virtual CPU
devices, the global waterfill against JAX's whole-mask one, and the
frame-parallel ``render_video`` against the one-process render.

Every check is exact: the batch split (each rank's leaves equal the JAX
shards, the replicated leaves whole), ``host_local_slice``, the global-batch
checksum, the mesh shapes, the waterfill masks, the gathered rows and their
gradient, and the frames (bit-equal uint8).
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from geneface_tpu.ops.compaction import waterfill_valid as jwaterfill
from geneface_tpu.parallel import make_mesh as jmake_mesh
from geneface_tpu.parallel import mesh as jmesh_mod
from geneface_tpu.parallel import shard_batch as jshard_batch
from geneface_tpu_torch import parallel
from geneface_tpu_torch.training.trainer import Task

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import torch_ddp_helpers as ddp  # noqa: E402
from test_torch_training import tiny_cfg  # noqa: E402
from tools.make_synthetic_dataset import make_dataset  # noqa: E402

torch.set_num_threads(1)

N_RAYS, SLOTS = 64, 8


def _mask():
    """A prefix-dense [64, 8] march mask whose first half of rays is deep
    and second half shallow, so a per-rank waterfill at half the budget
    cuts the two halves at different levels."""
    rng = np.random.RandomState(0)
    n = np.concatenate([rng.randint(5, 9, N_RAYS // 2), rng.randint(0, 4, N_RAYS // 2)])
    return np.arange(SLOTS)[None, :] < n[:, None]


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    rng = np.random.RandomState(1)
    batch = {"rays": rng.randn(8, 3).astype(np.float32),
             "inds": np.arange(8, dtype=np.int32),
             "odd": rng.randn(3, 2).astype(np.float32),  # 3 rows: kept whole
             "cond": rng.randn(1, 5).astype(np.float32),
             "scalar": np.float32(2.5)}
    mask = _mask()
    capacity = int(mask.sum() * 0.6)
    spec = dict(batch=batch, global_len=10, mask=mask, capacity=capacity,
                weights=rng.randn(4, 2).astype(np.float32))
    out = ddp.run_ranks("mesh", spec, 2, str(tmp_path_factory.mktemp("mesh")))
    return spec, out


def test_mesh_shapes(mesh_ranks):
    _, out = mesh_ranks
    for r in out:
        assert r["shape"] == (2, 1)
        assert r["shape_2d"] == (1, 2) and r["dims_2d"] == ("data", "model")
    jm = jmake_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    assert tuple(jm.shape.values()) == out[0]["shape_2d"] and jm.axis_names == out[0]["dims_2d"]


def test_shard_batch_matches_jax(mesh_ranks):
    spec, out = mesh_ranks
    jmesh = jmake_mesh(devices=jax.devices()[:2])
    want = jshard_batch(jmesh, spec["batch"])
    for k, arr in want.items():
        order = list(jmesh.devices.flat)
        shards = sorted(arr.addressable_shards, key=lambda s: order.index(s.device))
        for r in range(2):
            np.testing.assert_array_equal(np.asarray(out[r]["shard"][k]),
                                          np.asarray(shards[r].data), err_msg=f"{k} @ rank {r}")
    assert out[0]["shard"]["rays"].shape == (4, 3) and out[1]["shard"]["odd"].shape == (3, 2)


def test_host_local_slice_matches_jax(mesh_ranks, monkeypatch):
    spec, out = mesh_ranks
    monkeypatch.setattr(jmesh_mod.jax, "process_count", lambda: 2)
    for r in range(2):
        monkeypatch.setattr(jmesh_mod.jax, "process_index", lambda r=r: r)
        assert out[r]["slice"] == jmesh_mod.host_local_slice(spec["global_len"])
    assert parallel.host_local_slice(10) == slice(0, 10)  # one process


def test_global_batch_check(mesh_ranks):
    spec, out = mesh_ranks
    # equal batches passed; one rank's differing batch raised on both ranks
    assert out[0]["check_raised"] and out[1]["check_raised"]
    x = spec["batch"]["rays"]
    assert parallel.global_batch_checksum(x) == float(np.float64(np.asarray(x, np.float64).sum()))
    assert parallel.global_batch_checksum(torch.as_tensor(x)) == parallel.global_batch_checksum(x)
    assert parallel.global_batch_checksum(np.array(["a"])) == 0.0


def test_global_waterfill_matches_jax_whole_mask(mesh_ranks):
    spec, out = mesh_ranks
    mask, capacity = spec["mask"], spec["capacity"]
    assert capacity < mask.sum()  # the budget binds
    want = np.asarray(jwaterfill(mask, capacity))
    got = np.concatenate([out[0]["waterfill"], out[1]["waterfill"]])
    np.testing.assert_array_equal(got, want)
    assert got.sum() <= capacity
    # each rank alone at half the budget keeps other samples: the global
    # waterfill is needed
    alone = np.concatenate([out[0]["waterfill_alone"], out[1]["waterfill_alone"]])
    assert not np.array_equal(alone, want)
    # one rank without a group is the JAX function
    from geneface_tpu_torch.ops.compaction import waterfill_valid

    np.testing.assert_array_equal(waterfill_valid(torch.as_tensor(mask), capacity).numpy(), want)


def test_gather_rows_and_its_gradient(mesh_ranks):
    spec, out = mesh_ranks
    full = np.asarray([[1.0, 1.0], [1.0, 1.0], [12.0, 12.0], [12.0, 12.0]], np.float32)
    w = spec["weights"]
    for r in range(2):
        np.testing.assert_array_equal(out[r]["gathered"], full)
        # d/dθ of sum(w · [θ; 2θ + 10]) = w[:2] + 2·w[2:], on every rank
        np.testing.assert_allclose(out[r]["gather_grad"], w[:2] + 2 * w[2:], rtol=1e-6)


def test_alone_the_helpers_do_nothing(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.initialize_distributed() is None
    assert parallel.initialize_distributed("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    task = Task({})
    assert task.setup_mesh() is None
    batch = {"inds": np.arange(4)}
    assert task.place_batch(batch) is batch and task.local_rows(batch["inds"]) is batch["inds"]
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.full((3,), 2.0)
    task.sync_grads([p])
    assert torch.equal(p.grad, torch.full((3,), 2.0))
    m = {"loss": torch.tensor(1.0)}
    assert task.reduce_metrics(m) is m
    # an incomplete torchrun environment and a missing card raise
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="incomplete torchrun environment"):
        parallel.initialize_distributed("cpu")
    for k, v in dict(RANK="0", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            parallel.initialize_distributed()


def test_frame_parallel_render_video_is_bit_equal(tmp_path):
    """Three frames over two ranks (the last group padded with the last
    frame) against the one-process render; rank 0 alone writes."""
    from geneface_tpu_torch.inference.radnerf_infer import RADNeRFInfer

    data = str(tmp_path / "data")
    make_dataset(data, n_frames=6, hw=32)
    cfg = tiny_cfg(data, str(tmp_path / "work"), max_updates=2, val_check_interval=2,
                   n_rays=256, mean_samples_per_ray=8, lattice_K=32, update_extra_interval=1,
                   num_sanity_val_steps=0, val_render_frame=False)
    ddp.job_fit({"cfg": cfg})
    spec = {"cfg": cfg, "n_frames": 3, "out_path": str(tmp_path / "out.mp4")}
    r0, r1 = ddp.run_ranks("render", spec, 2, str(tmp_path / "ranks"))
    assert r0["path"] == r1["path"] == spec["out_path"]
    assert r1["frames"] is None  # rank 1 muxes nothing
    want = RADNeRFInfer(cfg, device="cpu").render_frames(3)
    assert want.std() > 0
    np.testing.assert_array_equal(r0["frames"], want)
