"""The port's torso training against the JAX torso task on a tiny config
(64² synthetic scene, 256 rays, widths 16; the torso grid at its own full
width): one step's loss and gradients, the frozen head across steps, and
``tasks/run.py`` end to end with checkpoints that both packages load.

Tolerances: one step at float32 MLPs, the head rendered through the walk
and the slab with JAX's march noise — loss rel 1e-5; every torso
parameter's gradient within a relative L2 error of 1e-4 of the eager JAX
gradient (sums in another order). The deform nets and the torso grid's hash
group come closest (6e-5 to 1e-4, the same whatever the thread count): the
two sides' matmuls round the deformed coordinate apart by an ulp, which
moves a finest-level (resolution 2048) corner weight by ~1e-4 relative;
every other gradient agrees to 1e-6. The JAX head gradients are exactly
zero and the port's head has none; after ``train_step`` every head
parameter is bit-identical.
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
from geneface_tpu.inference.radnerf_infer import RADNeRFInfer as JInfer
from geneface_tpu.models.radnerf import RADNeRFTorso as JTorso
from geneface_tpu.models.radnerf.renderer import OccupancyState as JOcc
from geneface_tpu.models.radnerf.renderer import TorsoOccupancyState as JTorsoOcc
from geneface_tpu.tasks.radnerf import model_from_cfg as jmodel_from_cfg
from geneface_tpu.tasks.radnerf_torso import RADNeRFTorsoTask as JTorsoTask
from geneface_tpu.utils import load_checkpoint as jload_checkpoint
from geneface_tpu.utils.checkpoint import save_checkpoint as jsave
from geneface_tpu_torch.convert import flax_path, flax_to_state_dict
from geneface_tpu_torch.models.radnerf import OccupancyState, TorsoOccupancyState
from geneface_tpu_torch.tasks.radnerf_torso import RADNeRFTorsoTask
from geneface_tpu_torch.training.optim import torso_label_fn

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.make_synthetic_dataset import make_dataset  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_cfg(data_dir, **over):
    cfg = dict(
        data_dir=data_dir, cond_type="idexp_lm3d_normalized", cond_win_size=1,
        smo_win_size=3, cond_out_dim=16, with_att=True, bound=1, grid_type="tiledgrid",
        log2_hashmap_size=9, desired_resolution=128, grid_size=32,
        num_layers_ambient=2, hidden_dim_ambient=16, num_layers_sigma=2,
        hidden_dim_sigma=16, geo_feat_dim=16, num_layers_color=2,
        hidden_dim_color=16, individual_embedding_num=16,
        individual_embedding_dim=4, n_rays=256, max_steps=8,
        update_extra_interval=4, dt_gamma=1.0 / 256, min_near=0.05, lr=5e-3,
        scheduler="exponential", max_updates=4, val_check_interval=2,
        tb_log_interval=2, num_sanity_val_steps=1, eval_max_batches=1,
        num_ckpt_keep=2, lambda_weights_entropy=1e-4, native_loader=False, seed=0,
        torso_head_aware=True, density_thresh_torso=0.01,
    )
    cfg.update(over)
    return cfg


def _ball(H, radius=0.5):
    r = (np.arange(H) + 0.5) / H * 2.0 - 1.0
    gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
    occ = np.sqrt(gx**2 + gy**2 + gz**2) < radius
    return np.where(occ, 40.0, 0.0).reshape(1, -1).astype(np.float32), occ[None]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The synthetic video, and a head checkpoint written by the JAX package
    (JAX-initialised head, an occupancy ball) for ``head_model_dir``."""
    root = tmp_path_factory.mktemp("torch_torso_train")
    data = str(root / "data")
    make_dataset(data, n_frames=8, hw=64)
    head_dir = str(root / "head")
    cfg = tiny_cfg(data)
    jmodel = jmodel_from_cfg(JConfig(cfg), JTorso, dtype=jnp.float32, torso_head_aware=True)
    params = jax.jit(lambda key: jmodel.init(
        key, jnp.zeros((3, 1, 204)), jnp.zeros((8, 3)), jnp.zeros((8, 3)),
        method=jmodel.init_all,
    ))(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.array, params)
    params["params"]["sigma_net"]["Dense_1"]["kernel"][:, 0] += 0.5
    head = {k: v for k, v in params["params"].items()
            if "torso" not in k and "head_aware" not in k}
    dens, occ = _ball(cfg["grid_size"])
    jsave(os.path.join(head_dir, "model_ckpt_steps_10.ckpt"), {
        "state": {"params": {"params": head}, "occ": (dens, occ, np.float32(0.0))},
        "step": 10,
    })
    return data, head_dir, params, (dens, occ, np.float32(0.0))


@pytest.fixture(scope="module")
def step_case(scene):
    """The JAX torso loss and the port's task on the same parameters (the
    JAX init behind the head checkpoint), the head's occupancy ball, a
    planted torso occupancy and one batch, with the JAX value and gradients
    of the torso loss at float32."""
    data, head_dir, params, occ = scene
    cfg = tiny_cfg(data, head_model_dir=head_dir)
    jtask = JTorsoTask(JConfig(cfg))  # the parts of build() that the loss reads
    jtask.model = jmodel_from_cfg(JConfig(cfg), JTorso, dtype=jnp.float32, torso_head_aware=True)
    jtask.train_ds = JDataset("train", data, JConfig(cfg), training=True)
    jtask.grid_size = H = cfg["grid_size"]
    jstate = {"params": params, "occ": JOcc(*map(jnp.asarray, occ))}
    g = np.zeros((H, H), np.float32)
    g[:, H // 2 + 1:] = 0.5
    torso_occ = (g.reshape(-1), np.float32(g.mean()))
    batch = jtask.train_ds[3]
    dbatch = jtask._device_batch(batch, 0)
    dbatch["pose"] = jnp.asarray(batch["pose"])
    rng = jax.random.PRNGKey(3)
    # eager, as the JAX package's own gradient tests run it: under jax.jit
    # XLA's CPU compiler puts the torso grid's hash-group and deform
    # gradients 5-13% (relative L2) off a float64 evaluation of the same
    # loss, while the eager gradients agree with it to 1e-4
    (jloss, jlosses), jgrads = jax.value_and_grad(
        lambda p: jtask._loss_fn_torso(
            p, jstate["occ"], JTorsoOcc(*map(jnp.asarray, torso_occ)), dbatch, rng, True),
        has_aux=True,
    )(jstate["params"])
    noises = np.asarray(jax.random.uniform(rng, (len(batch["inds"]),)))  # renderer.py:401
    return cfg, jstate, torso_occ, batch, noises, (jloss, jlosses, jgrads)


def _port_task(cfg, jstate, torso_occ):
    task = RADNeRFTorsoTask(cfg, device="cpu", dtype=torch.float32)
    task.build()
    task.model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in flax_to_state_dict(jstate["params"]).items()}
    )
    task.set_occupancy(OccupancyState(*[torch.from_numpy(np.array(x)) for x in jstate["occ"]]))
    task.torso_occ = TorsoOccupancyState(*[torch.from_numpy(np.array(x)) for x in torso_occ])
    return task


def test_torso_step_loss_and_grads_match(step_case):
    cfg, jstate, torso_occ, batch, noises, (jloss, jlosses, jgrads) = step_case
    task = _port_task(cfg, jstate, torso_occ)
    loss, losses = task.loss_fn(task.device_batch(batch, 0), torch.from_numpy(noises), train=True)
    loss.backward()
    assert float(losses["mean_samples"]) > 1.0  # the head's rays do hit the ball
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in ("torso_mse_loss", "torso_weights_entropy_loss"):
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=1e-5, err_msg=k)
    named = dict(task.model.named_parameters())
    n_torso = 0
    for name, want in flax_to_state_dict(jgrads).items():
        got = named[name].grad
        if torso_label_fn("/".join(("params",) + flax_path(name))) == "frozen":
            assert not named[name].requires_grad and got is None, name
            assert not np.any(want), name  # the head gets no gradient in JAX either
            continue
        n_torso += 1
        assert got is not None, name
        if name == "torso_individual_codes":  # one row is used
            assert np.abs(want).max() > 0
        err = float(np.linalg.norm(got.numpy() - want) / max(np.linalg.norm(want), 1e-30))
        assert err <= 1e-4, (name, err)
    assert n_torso == 15  # grid x2, codes, deform x3, canonical x3, head-aware x6


def test_train_steps_keep_the_head_bit_identical(step_case):
    cfg, jstate, torso_occ, batch, _, _ = step_case
    task = _port_task(cfg, jstate, torso_occ)
    head = {n: p.detach().clone() for n, p in task.model.named_parameters() if not p.requires_grad}
    torso = {n: p.detach().clone() for n, p in task.model.named_parameters() if p.requires_grad}
    head_occ = [x.clone() for x in task.occ]
    for step in range(2):
        out = task.train_step(batch)
        assert out["occupancy_sweep"] == float(step == 0)
        assert np.isfinite(float(out["total_loss"]))
    for n, p in task.model.named_parameters():
        if n in head:
            assert torch.equal(p, head[n]), n
        else:
            assert not torch.equal(p, torso[n]), n
    assert all(torch.equal(a, b) for a, b in zip(task.occ, head_occ))
    assert float(task.torso_occ.mean_density) > 0  # the sweep saw the torso


def test_run_cli_trains_the_torso_and_both_packages_load_it(scene, tmp_path):
    import yaml

    from geneface_tpu_torch.inference import RADNeRFInfer
    from geneface_tpu_torch.tasks.run import main

    data, head_dir, _, _ = scene
    cfg = tiny_cfg(data, head_model_dir=head_dir)
    cfg["base_config"] = [os.path.join(REPO, "egs/egs_bases/radnerf/lm3d_radnerf_torso.yaml")]
    path = tmp_path / "torso.yaml"
    path.write_text(yaml.safe_dump(cfg))
    work = str(tmp_path / "exp")
    assert main(["--config", str(path), "--exp_name", work, "--device", "cpu"]) == 4
    ckpts = sorted(f for f in os.listdir(work) if f.startswith("model_ckpt_steps_"))
    assert ckpts == ["model_ckpt_steps_2.ckpt", "model_ckpt_steps_4.ckpt"]
    state = jload_checkpoint(os.path.join(work, "model_ckpt_steps_4.ckpt"))["state"]
    assert float(state["torso_occ"][1]) > 0 and state["occ"][1].any()
    # the head came from head_model_dir and stayed frozen
    head = jload_checkpoint(os.path.join(head_dir, "model_ckpt_steps_10.ckpt"))["state"]
    np.testing.assert_array_equal(state["params"]["params"]["sigma_net"]["Dense_1"]["kernel"],
                                  head["params"]["params"]["sigma_net"]["Dense_1"]["kernel"])

    full = dict(cfg, work_dir=work)
    jinf = JInfer(JConfig(full))
    assert jinf.torso
    infer = RADNeRFInfer(full, device="cpu")
    assert infer.torso
    for k, v in flax_to_state_dict(jinf.params).items():
        np.testing.assert_array_equal(infer.model.state_dict()[k].numpy(), v, err_msg=k)
    frames = infer.render_frames(1)
    assert frames.shape == (1, 64, 64, 3) and frames.dtype == np.uint8
