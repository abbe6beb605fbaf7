"""The lip fine-tune phase of the port's head task against the JAX task, on
the tiny config of ``tests/test_torch_training.py`` at ``lip_patch_size``
32 (the smallest patch LPIPS takes; the frames are 64²) with seeded random
LPIPS weights (``allow_random_lpips``; the released ones are not in the
repo), carried from the JAX init by ``convert.lpips_state_dict``.

Tolerances, per check:
- the lip patch's pixel indices and pixels: exact, on the face-rect
  fallback (the synthetic frames have no ``lms``), the ``lms[48:60]``
  branch and a stored ``lip_rect`` (planted in three training samples);
- the lip loss at float32 MLPs with the same explicit march noise and the
  same rays: each term within rtol 1e-5, ``mean_samples`` and
  ``march_span`` exact, every gradient within rtol 1e-4 and atol 1e-5 ×
  max |g| (the bounds of ``test_train_step_loss_and_grads_match``). Both
  sides take the rays that the JAX package rebuilds from the patch's pixel
  indices: the two rebuilds differ in the last bit of some directions
  (XLA reassociates the division and the norm differently from one program
  to the next), and on the dense 32×32 patch a sample that sits on a grid
  cell's edge then interpolates from the next cell, which moves the
  position grid's gradient by ~1e-3 × max |g| (measured: 4.3e-3 with each
  side's own rays, 1.3e-6 with the same rays);
- the lip and sweep steps of 12 ``train_step`` calls, and the capacity
  buckets after a lip step: exact.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneface_tpu.config import Config as JConfig
from geneface_tpu.data.radnerf_dataset import RADNeRFDataset as JDataset
from geneface_tpu.models.radnerf import RADNeRF as JRADNeRF
from geneface_tpu.tasks.radnerf import RADNeRFTask as JTask
from geneface_tpu.tasks.radnerf import model_from_cfg as jmodel_from_cfg
from geneface_tpu_torch.convert import flax_to_state_dict, lpips_state_dict
from geneface_tpu_torch.data.radnerf_dataset import RADNeRFDataset
from geneface_tpu_torch.models.radnerf import OccupancyState
from geneface_tpu_torch.tasks.radnerf import RADNeRFTask

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.make_synthetic_dataset import make_dataset  # noqa: E402

from test_torch_training import tiny_cfg  # noqa: E402

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: training samples with landmarks (one centred, one whose patch is
#: clipped at the frame's edge) and one with a stored lip rect
LMS_SAMPLES = {1: (40, 50, 20, 34), 6: (55, 62, 40, 47)}
LIP_RECT_SAMPLES = {3: (5, 15, 50, 60)}


def lip_cfg(data_dir, work_dir="", **over):
    return tiny_cfg(data_dir, work_dir, finetune_lips=True, finetune_lips_start_iter=4,
                    lip_patch_size=32, allow_random_lpips=True, lambda_lpips_loss=0.01,
                    mean_samples_per_ray=8, lattice_K=32, **over)


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    """The 64² synthetic video with ``lms`` planted in two training samples
    and a ``lip_rect`` in a third."""
    d = str(tmp_path_factory.mktemp("torch_lip"))
    make_dataset(d, n_frames=12, hw=64)
    path = os.path.join(d, "trainval_dataset.npy")
    ds = np.load(path, allow_pickle=True).tolist()
    for i, (x0, x1, y0, y1) in LMS_SAMPLES.items():
        lms = np.zeros((68, 2), np.float32)
        t = np.linspace(0, 2 * np.pi, 12, endpoint=False)
        lms[48:60, 1] = (x0 + x1) / 2 + (x1 - x0) / 2 * np.cos(t)  # rows
        lms[48:60, 0] = (y0 + y1) / 2 + (y1 - y0) / 2 * np.sin(t)  # columns
        ds["train_samples"][i]["lms"] = lms
    for i, rect in LIP_RECT_SAMPLES.items():
        ds["train_samples"][i]["lip_rect"] = rect
    np.save(path, ds, allow_pickle=True)
    return d


# --------------------------------------------------------------- dataset --
@pytest.mark.parametrize("branch", ["face_rect", "lms", "lip_rect"])
def test_lip_patch_matches(synth_dir, branch):
    cfg = lip_cfg(synth_dir)
    jds = JDataset("train", synth_dir, JConfig(cfg), training=True)
    tds = RADNeRFDataset("train", synth_dir, cfg, training=True)
    assert tds.lips_rects == jds.lips_rects
    special = set(LMS_SAMPLES) | set(LIP_RECT_SAMPLES)
    frames = {"face_rect": [i for i in range(len(tds)) if i not in special],
              "lms": list(LMS_SAMPLES), "lip_rect": list(LIP_RECT_SAMPLES)}[branch]
    jds.finetune_lip_flag = tds.finetune_lip_flag = True
    for idx in frames:
        want, got = jds[idx], tds[idx]
        assert got["is_lip_patch"] and want["is_lip_patch"]
        assert tuple(int(v) for v in got["lip_rect"]) == tuple(int(v) for v in want["lip_rect"])
        assert len(got["inds"]) == 32 * 32
        for k in ("inds", "gt_img_u8", "bg_img_u8", "bg_torso_img_u8", "face_rect"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} of frame {idx}")
    if branch == "lms":  # the second sample's patch is clipped to the frame
        assert int(tds[6]["lip_rect"][1]) == 64
    # out of the lip phase the items are random rays again, drawn alike
    jds.finetune_lip_flag = tds.finetune_lip_flag = False
    want, got = jds[frames[0]], tds[frames[0]]
    assert "is_lip_patch" not in got
    np.testing.assert_array_equal(got["inds"], want["inds"])


# ------------------------------------------------------------- lip loss --
@pytest.fixture(scope="module")
def lip_case(synth_dir):
    """The JAX task and the port's on the same params, LPIPS weights,
    occupancy (after one JAX sweep) and lip batch, at float32 MLPs; the
    JAX lip loss and gradients with the noise of ``PRNGKey(3)``."""
    cfg = lip_cfg(synth_dir)
    jtask = JTask(JConfig(cfg))
    jstate = jtask.build()
    params = jstate["params"]
    occ = jtask._occ_update_fn(params, jstate["occ"], jnp.asarray(jtask.train_ds.conds[:3]),
                               jax.random.PRNGKey(1))
    jtask.model = jmodel_from_cfg(JConfig(cfg), JRADNeRF, dtype=jnp.float32)
    jtask.train_ds.finetune_lip_flag = True
    batch = jtask.train_ds[2]
    step = 201_000
    # the expanded batch (rays rebuilt once, on the JAX side), without the
    # pixel indices, so that the loss does not rebuild them
    jbatch = {k: v for k, v in jtask._expand_light_batch(jtask._device_batch(batch, step)).items()
              if k != "inds"}
    rng = jax.random.PRNGKey(3)
    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtask._loss_fn(p, occ, jbatch, rng, train=True, lip=True), has_aux=True
    ))(params)

    task = RADNeRFTask(cfg, device="cpu", dtype=torch.float32)
    task.build()
    task.model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in flax_to_state_dict(params).items()})
    task.lpips.load_state_dict(
        {k: torch.from_numpy(v) for k, v in lpips_state_dict(jtask.lpips_params).items()})
    task.set_occupancy(OccupancyState(*[torch.from_numpy(np.array(x)) for x in occ]))
    # retuned buckets that the lip step must not use
    task._spr_bucket, task._latk_bucket = 2.0, 16
    noises = torch.from_numpy(np.asarray(jax.random.uniform(rng, (len(batch["inds"]),))))
    tbatch = task.device_batch(batch, step)
    for k in ("rays_o", "rays_d"):
        assert float((tbatch[k] - torch.from_numpy(np.array(jbatch[k]))).abs().max()) < 1e-6
        tbatch[k] = torch.from_numpy(np.array(jbatch[k]))
    loss, losses = task.loss_fn(tbatch, noises, train=True, lip=True)
    loss.backward()
    return jtask, task, jlosses, jgrads, losses


def test_lip_loss_and_grads_match(lip_case):
    _, task, jlosses, jgrads, losses = lip_case
    assert float(losses["lpips_loss"].detach()) > 0
    assert float(jlosses["mean_samples"]) > 1.0  # the patch's rays hit the occupied cells
    for k in ("mean_samples", "march_span"):
        assert float(losses[k]) == float(jlosses[k]), k
    for k in ("mse_loss", "weights_entropy_loss", "ambient_loss", "lpips_loss", "total_loss"):
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=1e-5, err_msg=k)
    named = dict(task.model.named_parameters())
    for name, want in flax_to_state_dict(jgrads).items():
        got = named[name].grad
        assert got is not None, name
        scale = float(np.abs(want).max())
        assert scale > 0, name
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)


def test_buckets_after_a_lip_step_match(lip_case):
    """A lip step renders at the config's capacities, yet the retune still
    reads its losses: the buckets it picks equal the JAX task's."""
    jtask, task, jlosses, _, losses = lip_case
    jtask._last_losses = None  # the first check retunes, in both tasks
    task._checked = False
    jtask._step = task._step = 201_000
    jtask._maybe_retune_capacity(jlosses)
    task.maybe_retune_capacity(losses)
    assert (task._spr_bucket, task._latk_bucket) == (jtask._spr_bucket, jtask._latk_bucket)
    assert task._spr_bucket is not None and task._latk_bucket is not None


# ------------------------------------------------------------- schedule --
def test_lip_and_sweep_steps_match(synth_dir):
    """Twelve steps with the phase from step 4 and a sweep every 4: the lip
    steps alternate from step 5 and the sweep is frozen from step 5, in
    both tasks (synchronous iterators, so a flag change takes effect at the
    next item; the prefetching one delivers it one item late in both)."""
    cfg = lip_cfg(synth_dir)
    jtask = JTask(JConfig(cfg))
    state = jtask.build()
    jsweeps, jlips = [], []
    real = jtask._occ_update_fn

    def counting(*args):
        jsweeps.append(jtask._step)
        return real(*args)

    jtask._occ_update_fn = counting
    jtask._step = 0
    it = jtask.train_ds.iter_epochs(0, prefetch=False)
    rng = jax.random.PRNGKey(0)
    for i in range(12):
        batch = next(it)
        jlips += [i] if batch.get("is_lip_patch") else []
        rng, k = jax.random.split(rng)
        state, _ = jtask.train_step(state, batch, k)

    task = RADNeRFTask(cfg, device="cpu")
    task.build()
    it = task.train_ds.iter_epochs(prefetch=False)
    sweeps, lips = [], []
    for i in range(12):
        losses = task.train_step(next(it))
        sweeps += [i] if losses["occupancy_sweep"] else []
        lips += [i] if "lpips_loss" in losses else []
        assert np.isfinite(float(losses["total_loss"]))
    assert (lips, sweeps) == (jlips, jsweeps) == ([5, 7, 9, 11], [0, 4])
    assert task.finetune_lip_flag == jtask.finetune_lip_flag


def test_run_cli_trains_through_the_lip_phase(synth_dir, tmp_path):
    """``tasks/run.py`` on the tiny head config with ``finetune_lips``:
    the lip steps log ``lpips_loss``; a second run resumes."""
    import json

    import yaml

    from geneface_tpu_torch.tasks.run import main

    cfg = lip_cfg(synth_dir, max_updates=8, val_check_interval=4, tb_log_interval=1,
                  smo_win_size=5)
    del cfg["work_dir"]
    cfg["base_config"] = [os.path.join(REPO, "egs/egs_bases/radnerf/lm3d_radnerf.yaml")]
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    work = str(tmp_path / "exp")
    assert main(["--config", str(path), "--exp_name", work, "--device", "cpu"]) == 8
    lines = [json.loads(x) for x in open(os.path.join(work, "metrics.jsonl"))]
    lip_steps = [r["step"] for r in lines if "tr/lpips_loss" in r]
    # the flag is set after the step of index 4; the prefetching iterator
    # delivers it one item late, so the step of index 6 (logged as step 7)
    # is the lip step of these 8
    assert lip_steps == [7], lip_steps
    assert main(["--config", str(path), "--exp_name", work, "--device", "cpu",
                 "--hparams", "max_updates=10"]) == 10
    assert sorted(f for f in os.listdir(work) if f.startswith("model_ckpt")) == [
        "model_ckpt_best.ckpt", "model_ckpt_steps_10.ckpt", "model_ckpt_steps_8.ckpt"]
