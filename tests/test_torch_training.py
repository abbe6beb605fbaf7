"""The port's training slice against the JAX package on the tiny config of
``tests/test_radnerf_training.py`` (64² synthetic scene, 256 rays, widths
16): the dataset's batches, the occupancy update, the schedules and the
optimizer, one whole step's loss and gradients, and ``tasks/run.py`` end to
end.

Tolerances, stated per check:
- dataset batches (indices, uint8 pixels, face rect, condition windows)
  and ``mark_untrained_grid``: exact;
- ``update_extra_state`` with JAX's noise: density grid rtol 1e-5, and
  ``occ_grid`` equal wherever the density is further than 1e-5 from the
  threshold;
- schedules: rtol 1e-6; three Adam steps on the same gradients: atol 1e-7,
  rtol 1e-6 (optax's order of operations, float32);
- one training step at float32 MLPs: loss rel 1e-5, every parameter's
  gradient within rtol 1e-4, atol 1e-5·max|g|: a table entry sums
  thousands of terms in another order, and where they cancel the error
  scales with the terms, not the result (1e-6·max|g| fails at 2.2e-6); at
  the bf16 default a hidden unit can round the other way on one side: loss
  rel 1e-3 and per-parameter cosine >= 0.999.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geneface_tpu.config import Config as JConfig
from geneface_tpu.data.radnerf_dataset import RADNeRFDataset as JDataset
from geneface_tpu.models.radnerf import RADNeRF as JRADNeRF
from geneface_tpu.models.radnerf.renderer import init_occupancy as jinit_occ
from geneface_tpu.models.radnerf.renderer import mark_untrained_grid as jmark
from geneface_tpu.models.radnerf.renderer import update_extra_state as jupdate
from geneface_tpu.tasks.radnerf import RADNeRFTask as JTask
from geneface_tpu.tasks.radnerf import model_from_cfg as jmodel_from_cfg
from geneface_tpu.training import schedules as jsched
from geneface_tpu.training.optim import finalize_optimizer, multi_group_adam
from geneface_tpu.training.optim import radnerf_label_fn as jlabel
from geneface_tpu.utils import load_checkpoint as jload_checkpoint
from geneface_tpu_torch.convert import flax_to_state_dict
from geneface_tpu_torch.data.radnerf_dataset import RADNeRFDataset
from geneface_tpu_torch.models.radnerf import (
    OccupancyState,
    init_occupancy,
    mark_untrained_grid,
    model_from_cfg,
    update_extra_state,
)
from geneface_tpu_torch.tasks.radnerf import RADNeRFTask
from geneface_tpu_torch.training import schedules
from geneface_tpu_torch.training.optim import build_optimizer

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.make_synthetic_dataset import make_dataset  # noqa: E402

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_cfg(data_dir, work_dir, **over):
    cfg = dict(
        data_dir=data_dir, work_dir=work_dir,
        cond_type="idexp_lm3d_normalized", cond_win_size=1, smo_win_size=3,
        cond_out_dim=16, with_att=True, bound=1, grid_type="tiledgrid",
        log2_hashmap_size=9, desired_resolution=128, grid_size=32,
        num_layers_ambient=2, hidden_dim_ambient=16, num_layers_sigma=2,
        hidden_dim_sigma=16, geo_feat_dim=16, num_layers_color=2,
        hidden_dim_color=16, individual_embedding_num=16,
        individual_embedding_dim=4, n_rays=256, max_steps=8,
        update_extra_interval=4, density_thresh=10, dt_gamma=1.0 / 256,
        near=0.3, far=0.9, min_near=0.05, lr=5e-3, scheduler="exponential",
        max_updates=12, val_check_interval=6, tb_log_interval=4,
        num_sanity_val_steps=1, eval_max_batches=2, num_ckpt_keep=2,
        finetune_lips=False, lambda_weights_entropy=1e-4, lambda_ambient=0.1,
        native_loader=False, seed=0,
    )
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_train")
    make_dataset(str(d), n_frames=12, hw=64)
    return str(d)


# ---------------------------------------------------------------- dataset --
def test_dataset_batches_match(synth_dir):
    cfg = tiny_cfg(synth_dir, "")
    jds = JDataset("train", synth_dir, JConfig(cfg), training=True)
    tds = RADNeRFDataset("train", synth_dir, cfg, training=True)
    assert jds.native_loader is None
    np.testing.assert_array_equal(tds.poses, jds.poses)
    for idx in (0, 5, 5, 3):  # the ray draws advance both RandomStates
        want, got = jds[idx], tds[idx]
        for k in ("inds", "face_rect", "gt_img_u8", "bg_img_u8", "bg_torso_img_u8",
                  "cond_wins", "pose_matrix"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["idx"] == want["idx"]
    # the shuffled, prefetched epoch order draws as the JAX iterator does
    jit_, tit = jds.iter_epochs(), tds.iter_epochs()
    for _ in range(14):
        a, b = next(jit_), next(tit)
        assert a["idx"] == b["idx"]
        np.testing.assert_array_equal(a["inds"], b["inds"])


# -------------------------------------------------------------- occupancy --
def _density_np(x):
    return 30.0 * np.exp(-4.0 * (x**2).sum(-1))


def test_occupancy_mark_and_update_match(synth_dir):
    cfg = tiny_cfg(synth_dir, "")
    jds = JDataset("train", synth_dir, JConfig(cfg), training=True)
    H = cfg["grid_size"]
    jocc = jmark(jinit_occ(H, 1), jds.poses, jds.intrinsics, H, 1)
    tocc = mark_untrained_grid(init_occupancy(H, 1), jds.poses, jds.intrinsics, H, 1)
    np.testing.assert_array_equal(tocc.density_grid.numpy(), np.asarray(jocc.density_grid))
    assert (tocc.density_grid.numpy() == -1).any()

    rng = jax.random.PRNGKey(7)
    for _ in range(2):  # two sweeps: the EMA and the mean density carry over
        jocc = jupdate(
            lambda x: 30.0 * jnp.exp(-4.0 * jnp.sum(x**2, -1)), jocc, rng,
            grid_size=H, bound=1.0, density_thresh=10.0,
        )
        noise = np.stack([
            np.asarray(jax.random.uniform(jax.random.fold_in(rng, c), (H**3, 3)))
            for c in range(1)
        ])
        tocc = update_extra_state(
            lambda x: torch.from_numpy(_density_np(x.numpy())).float(), tocc,
            torch.from_numpy(noise), grid_size=H, bound=1.0, density_thresh=10.0,
        )
        rng = jax.random.fold_in(rng, 1)
    dens = np.asarray(jocc.density_grid)
    np.testing.assert_allclose(tocc.density_grid.numpy(), dens, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tocc.mean_density), float(jocc.mean_density), rtol=1e-5)
    thresh = min(float(jocc.mean_density), 10.0)
    away = np.abs(dens - thresh).reshape(np.asarray(jocc.occ_grid).shape) > 1e-5
    np.testing.assert_array_equal(tocc.occ_grid.numpy()[away], np.asarray(jocc.occ_grid)[away])
    assert tocc.occ_grid.any() and not tocc.occ_grid.all()


# ------------------------------------------------- schedules and optimizer --
@pytest.mark.parametrize("name", ["none", "warmup", "rsqrt", "exponential", "cosine"])
def test_schedules_match(name):
    cfg = dict(scheduler=name, lr=5e-3, warmup_updates=4, hidden_size=64, max_updates=2000)
    jf, tf = jsched.build_schedule(cfg), schedules.build_schedule(cfg)
    for step in (0, 1, 10, 10_000):
        want = float(jf(jnp.float32(step)))
        got = float(tf(torch.tensor(float(step))))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f"{name} @ {step}")


def _tiny_models(cfg, dtype=jnp.float32):
    jmodel = jmodel_from_cfg(JConfig(cfg), JRADNeRF, dtype=dtype)
    params = jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((3, 1, 204)), jnp.zeros((8, 3)),
        jnp.zeros((8, 3)), method=jmodel.init_all,
    )
    tmodel = model_from_cfg(cfg, dtype=torch.float32)
    tmodel.load_state_dict({k: torch.from_numpy(v) for k, v in flax_to_state_dict(params).items()})
    return jmodel, params, tmodel


@pytest.mark.parametrize("clip", [{}, {"clip_grad_norm": 0.5, "clip_grad_value": 0.02}])
def test_optimizer_matches_optax(synth_dir, clip):
    cfg = tiny_cfg(synth_dir, "", scheduler="warmup", warmup_updates=2, **clip)
    _, params, tmodel = _tiny_models(cfg)
    tx = multi_group_adam(
        params, jsched.build_schedule(cfg), jlabel, {"net": 1.0, "grid": 10.0, "att": 5.0},
        eps=1e-15, clip_grad_norm=cfg.get("clip_grad_norm", 0),
        clip_grad_value=cfg.get("clip_grad_value", 0),
    )
    tx = finalize_optimizer(tx, JConfig(cfg))
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    opt = build_optimizer(tmodel, schedules.build_schedule(cfg), cfg)
    rng = np.random.RandomState(0)
    named = dict(tmodel.named_parameters())
    for step in range(4):
        grads = jax.tree_util.tree_map(
            lambda p: rng.randn(*p.shape).astype(np.float32) * 0.03, params
        )
        if step == 2:  # a non-finite gradient: the step is skipped
            grads["params"]["sigma_net"]["Dense_0"]["kernel"][0, 0] = np.nan
        upd, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, upd)
        for name, g in flax_to_state_dict(grads).items():
            named[name].grad = torch.from_numpy(g)
        opt.step()
        for name, want in flax_to_state_dict(params).items():
            np.testing.assert_allclose(
                named[name].detach().numpy(), want, atol=1e-7, rtol=1e-6,
                err_msg=f"{name} after step {step}",
            )
    assert int(opt.count) == 3 and int(opt.skipped) == 1


# ------------------------------------------------------- one whole step ----
@pytest.fixture(scope="module")
def step_case(synth_dir):
    """The JAX task and the port's task on the same params, occupancy and
    batch (the occupancy after one JAX sweep)."""
    cfg = tiny_cfg(synth_dir, "")
    jtask = JTask(JConfig(cfg))
    jstate = jtask.build()
    params = jstate["params"]
    cond = jnp.asarray(jtask.train_ds.conds[:3])
    occ = jtask._occ_update_fn(params, jstate["occ"], cond, jax.random.PRNGKey(1))
    batch = jtask.train_ds[2]
    return cfg, jtask, params, occ, batch


@pytest.mark.parametrize(
    "dtype,jitter", [("f32", False), ("f32", True), ("bf16", False), ("bf16", True)]
)
def test_train_step_loss_and_grads_match(step_case, dtype, jitter):
    cfg, jtask, params, occ, batch = step_case
    jdtype, tdtype = {"f32": (jnp.float32, torch.float32),
                      "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jtask.model = jmodel_from_cfg(JConfig(cfg), JRADNeRF, dtype=jdtype)
    step = 1000
    dbatch = jtask._device_batch(batch, step)
    rng = jax.random.PRNGKey(3) if jitter else None
    (jloss, jlosses), jgrads = jax.value_and_grad(
        lambda p: jtask._loss_fn(p, occ, dbatch, rng, train=True), has_aux=True
    )(params)

    task = RADNeRFTask(cfg, device="cpu", dtype=tdtype)
    task.build()
    task.model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in flax_to_state_dict(params).items()}
    )
    task.set_occupancy(OccupancyState(*[torch.from_numpy(np.asarray(x)) for x in occ]))
    n = len(batch["inds"])
    noises = (
        torch.from_numpy(np.asarray(jax.random.uniform(rng, (n,)))) if jitter
        else torch.zeros(n)
    )
    loss, losses = task.loss_fn(task.device_batch(batch, step), noises, train=True)
    loss.backward()
    assert float(losses["mean_samples"]) == pytest.approx(float(jlosses["mean_samples"]))
    assert float(jlosses["mean_samples"]) > 1.0  # the rays do hit the occupied cells
    rel = 1e-5 if dtype == "f32" else 1e-3
    np.testing.assert_allclose(float(loss), float(jloss), rtol=rel)
    named = dict(task.model.named_parameters())
    for name, want in flax_to_state_dict(jgrads).items():
        got = named[name].grad
        assert got is not None, name
        got = got.numpy()
        scale = float(np.abs(want).max())
        assert scale > 0, name
        if dtype == "f32":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale, err_msg=name)
        else:
            cos = float((got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want)))
            assert cos >= 0.999, (name, cos)


# ------------------------------------------------------------ end to end --
def test_run_cli_trains_and_checkpoint_renders(synth_dir, tmp_path):
    import yaml

    from geneface_tpu_torch.inference import RADNeRFInfer
    from geneface_tpu_torch.tasks.run import main, resolve_task

    cfg = tiny_cfg(synth_dir, "", max_updates=6, val_check_interval=3, tb_log_interval=3,
                   mean_samples_per_ray=8, lattice_K=32)
    del cfg["work_dir"]
    cfg["base_config"] = [os.path.join(REPO, "egs/egs_bases/radnerf/lm3d_radnerf.yaml")]
    cfg["smo_win_size"] = 5
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    work = str(tmp_path / "exp")
    assert main(["--config", str(path), "--exp_name", work, "--device", "cpu"]) == 6
    ckpts = sorted(f for f in os.listdir(work) if f.startswith("model_ckpt_steps_"))
    assert ckpts == ["model_ckpt_steps_3.ckpt", "model_ckpt_steps_6.ckpt"]
    state = jload_checkpoint(os.path.join(work, "model_ckpt_steps_6.ckpt"))
    assert state["step"] == 6 and state["state"]["occ"][1].any()
    assert "cond_att_net" in state["state"]["params"]["params"]

    full = dict(cfg, work_dir=work, data_dir=synth_dir)
    infer = RADNeRFInfer(full, device="cpu")
    frames = infer.render_frames(1)
    assert frames.shape == (1, 64, 64, 3) and frames.dtype == np.uint8
    # a second run on the same work dir resumes from its newest checkpoint
    # (step 6 = max_updates: nothing is left to train, nothing is rewritten)
    mtime = os.path.getmtime(os.path.join(work, "model_ckpt_steps_6.ckpt"))
    assert main(["--config", str(path), "--exp_name", work, "--device", "cpu"]) == 6
    assert os.path.getmtime(os.path.join(work, "model_ckpt_steps_6.ckpt")) == mtime
    assert os.path.exists(os.path.join(work, "model_ckpt_best.ckpt"))
    # an unported task raises, and so does the lip phase without LPIPS
    # weights (the JAX guard's error)
    with pytest.raises(NotImplementedError):
        resolve_task("geneface_tpu.tasks.lm3d_nerf.Lm3dNeRFTask")
    with pytest.raises(ValueError, match="no LPIPS weights are configured"):
        RADNeRFTask(dict(cfg, finetune_lips=True), device="cpu").build()
