"""The port's own ``gf::`` spans (``torch.profiler.record_function``
ranges) on the CPU at a tiny size: a span changes no number, each span opens
once a unit of its work, and the loader's wait never stays open across the
training step that follows it.

Training under the profiler must give bit-identical parameters, Adam
moments, occupancy and generator state: a span is a host range and nothing
else (no device work, no read of the device, no random draw).
"""

import contextlib
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from geneface_tpu_torch.convert import state_dict_to_flax
from geneface_tpu_torch.data.radnerf_dataset import RADNeRFDataset
from geneface_tpu_torch.inference import OrbitCamera, RADNeRFInfer, RealtimeRenderer
from geneface_tpu_torch.models.radnerf import OccupancyState
from geneface_tpu_torch.ops import encoders, fused_grid, gather, scatter
from geneface_tpu_torch.tasks.radnerf import RADNeRFTask
from geneface_tpu_torch.tasks.radnerf_torso import RADNeRFTorsoTask
from geneface_tpu_torch.tools.make_synthetic_dataset import make_dataset
from geneface_tpu_torch.utils.checkpoint import save_checkpoint

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)

HEAD_STEPS = 5  # sweeps at steps 0 and 4


def _cfg(data_dir, work_dir, **over):
    cfg = dict(
        data_dir=data_dir, work_dir=work_dir,
        cond_type="idexp_lm3d_normalized", cond_win_size=1, smo_win_size=3,
        cond_out_dim=16, with_att=True, bound=1, grid_type="tiledgrid",
        log2_hashmap_size=9, desired_resolution=64, grid_size=16,
        num_layers_ambient=2, hidden_dim_ambient=16, num_layers_sigma=2,
        hidden_dim_sigma=16, geo_feat_dim=16, num_layers_color=2,
        hidden_dim_color=16, individual_embedding_num=16,
        individual_embedding_dim=4, n_rays=256, max_steps=8,
        update_extra_interval=4, density_thresh=10, dt_gamma=1.0 / 256,
        min_near=0.05, lr=5e-3, scheduler="exponential", max_updates=8,
        finetune_lips=False, lambda_weights_entropy=1e-4, lambda_ambient=0.1,
        native_loader=False, seed=0, torso_head_aware=True, density_thresh_torso=0.01,
    )
    cfg.update(over)
    return cfg


def _ball(H, radius=0.5):
    r = (np.arange(H) + 0.5) / H * 2.0 - 1.0
    gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
    occ = np.sqrt(gx**2 + gy**2 + gz**2) < radius
    return (np.where(occ, 40.0, 0.0).reshape(1, -1).astype(np.float32), occ[None],
            np.float32(0.0))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 32² synthetic video and a head checkpoint (the seeded init of the
    port's head, an occupancy ball) for serving and for the torso's head."""
    root = tmp_path_factory.mktemp("torch_spans")
    data, work = str(root / "data"), str(root / "head")
    make_dataset(data, n_frames=4, hw=32)
    cfg = _cfg(data, work)
    task = RADNeRFTask(cfg, device="cpu")
    task.build()
    sd = {k: v.detach().numpy() for k, v in task.model.state_dict().items()}
    save_checkpoint(os.path.join(work, "model_ckpt_steps_0.ckpt"),
                    {"state": {"params": state_dict_to_flax(sd), "occ": _ball(cfg["grid_size"])},
                     "step": 0})
    return cfg


def _names(prof):
    return [e.name for e in prof.events()]


def _count(prof, name):
    return _names(prof).count(name)


def _traced():
    return profile(activities=[ProfilerActivity.CPU])


# ------------------------------------------------- (a) the numbers stay ----
def _head_task(cfg):
    task = RADNeRFTask(cfg, device="cpu")
    task.build()
    task.set_occupancy(OccupancyState(*[torch.as_tensor(x) for x in _ball(cfg["grid_size"])]))
    return task


def _torso_task(cfg):
    task = RADNeRFTorsoTask(dict(cfg, head_model_dir=cfg["work_dir"]), device="cpu")
    task.build()
    return task


def _train(make, cfg, steps, traced):
    """The task's state after ``steps`` steps of ``train_step(next(batches))``."""
    task = make(cfg)
    batches = task.train_batches(0)
    with _traced() if traced else contextlib.nullcontext() as prof:
        losses = [task.train_step(next(batches))["total_loss"] for _ in range(steps)]
    opt = task.optimizer
    trained = [p for g in opt.param_groups for p in g["params"]]
    occ = task.torso_occ if isinstance(task, RADNeRFTorsoTask) else task.occ
    state = {
        "losses": torch.stack(losses),
        "params": [p.detach().clone() for p in task.model.parameters()],
        "mu": [opt.state[p]["mu"].clone() for p in trained],
        "nu": [opt.state[p]["nu"].clone() for p in trained],
        "occ": [x.clone() for x in occ],
        "generator": task.generator.get_state(),
        "step": task._step,
    }
    return state, prof


def _bit_equal(a, b):
    if isinstance(a, list):
        return len(a) == len(b) and all(_bit_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and bool(
            (a.reshape(-1).view(torch.uint8) == b.reshape(-1).view(torch.uint8)).all()
            if a.dtype != torch.bool else (a == b).all())
    return a == b


@pytest.mark.parametrize("kind", ["head", "torso"])
def test_training_is_bit_identical_under_the_profiler(scene, kind):
    make, steps = (_head_task, HEAD_STEPS) if kind == "head" else (_torso_task, 1)
    plain, _ = _train(make, scene, steps, traced=False)
    traced, prof = _train(make, scene, steps, traced=True)
    names = _names(prof)
    # the spans were open: the run was traced through the program's ranges
    assert names.count("gf::data_wait") == steps
    assert names.count("gf::grid_backward") >= steps
    assert names.count("gf::k1") >= steps and names.count("gf::k8") >= steps
    for key in plain:
        assert _bit_equal(plain[key], traced[key]), key


# ------------------------------------------- (b) one span a unit of work ----
def _grid_case(backend):
    kw = dict(input_dim=3, num_levels=4, level_dim=2, base_resolution=8,
              log2_hashmap_size=10, desired_resolution=64, gridtype="hash")
    meta = encoders.make_grid_meta(**kw)
    x = torch.rand(300, 3, generator=torch.Generator().manual_seed(0))
    if backend == "fused":
        fmeta = fused_grid.make_fused_grid_meta(meta)
        tables = [torch.rand(fused_grid.table_shape(fmeta, gi), requires_grad=True)
                  for gi in range(len(fmeta.groups))]
        views = [fused_grid.dense_view(t, fmeta, gi) if fmeta.modes[gi] == "dense" else t
                 for gi, t in enumerate(tables)]
        return lambda: fused_grid.fused_grid_encode(x, views, fmeta)
    bmeta = encoders.make_block_grid_meta(meta)
    emb = torch.rand(meta.n_entries, 2, requires_grad=True)
    return lambda: encoders.fast_grid_encode(x, emb, bmeta)


@pytest.mark.parametrize("backend", ["fused", "block"])
def test_grid_backward_span_per_backward(backend):
    encode = _grid_case(backend)
    with _traced() as prof:
        for _ in range(2):
            encode().square().sum().backward()
    assert _count(prof, "gf::grid_backward") == 2
    # the table scatters run inside it
    assert _count(prof, "gf::k1") >= 2


@pytest.mark.parametrize("prefetch", [True, False])
def test_data_wait_span_per_next(scene, prefetch):
    ds = RADNeRFDataset("train", scene["data_dir"], scene, training=True)
    it = ds.iter_epochs(prefetch=prefetch)
    with _traced() as prof:
        for _ in range(3):
            next(it)
    it.close()
    assert _count(prof, "gf::data_wait") == 3


@pytest.mark.parametrize("kernel", ["k1", "k8"])
def test_kernel_span_per_launch_call(kernel):
    rows = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    upd = torch.ones(4, 4)
    with _traced() as prof:
        for _ in range(3):
            if kernel == "k1":
                scatter.launch_scatter_add_rows(rows, upd, 6)
            else:
                gather.launch_gather_rows(upd, rows)
    assert _count(prof, f"gf::{kernel}") == 3
    assert _count(prof, "gf::k8" if kernel == "k1" else "gf::k1") == 0


@pytest.fixture(scope="module")
def infer(scene):
    return RADNeRFInfer(scene, device="cpu")


def test_clip_and_frame_spans_per_unit(scene, infer):
    n = 3
    lm3d = np.asarray(infer.dataset.idexp_lm3d_mean, np.float32).reshape(1, 68, 3).repeat(n, 0)
    with _traced() as prof:
        frames = infer.render_frames(n, lm3d)
    assert frames.shape[0] == n
    names = _names(prof)
    # per clip
    assert names.count("gf::prepare") == 1 and names.count("gf::conds") == 1
    # per frame; gf::frame_out once more around the clip's stack
    assert names.count("gf::frame_inputs") == n and names.count("gf::cond") == n
    assert names.count("gf::frame_out") == n + 1


def test_viewer_inputs_span_per_call(infer):
    rr = RealtimeRenderer(infer)
    cam = OrbitCamera(infer.dataset.W, infer.dataset.H)
    cam.update_intrinsics(infer.dataset.intrinsics)
    cam.update_pose(np.asarray(infer.dataset.poses[0]))
    with _traced() as prof:
        for _ in range(2):
            rr.inputs(cam)
    assert _count(prof, "gf::inputs") == 2


# ------------------------------------- (c) the wait closes before the step ----
@pytest.mark.parametrize("prefetch", [True, False])
def test_no_data_wait_is_open_while_a_step_runs(scene, prefetch):
    task = _head_task(scene)
    it = task.train_ds.iter_epochs(prefetch=prefetch)
    with _traced() as prof:
        for _ in range(2):
            task.train_step(next(it))
    it.close()
    events = prof.events()
    waits = [e.time_range for e in events if e.name == "gf::data_wait"]
    steps = [e.time_range for e in events
             if e.name in ("gf::batch", "gf::backward", "gf::optim", "gf::field")]
    assert len(waits) == 2 and steps
    for w in waits:
        for s in steps:
            assert w.end <= s.start or s.end <= w.start, (w, s)
