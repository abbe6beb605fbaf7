"""Torso training from an imported GeneFace checkpoint under the keys of
``egs/datasets/videos/May/lm3d_radnerf_import.yaml`` (the reference grid at
16 × 2 for the head and the torso, the head through the walk and the padded
slab) against the JAX torso task, on a 64² scene with JAX's march noise:
one step's loss within 1e-5 relative and every torso parameter's gradient
within a relative L2 error of 1e-4 of the eager JAX gradient, as
``tests/test_torch_torso_training.py`` holds the fused layout's; then two
steps keep the imported head bit-identical and the val frame renders.

The port's torso grid is read at JAX's deform output ``Δxy`` (its values,
the gradient through the port's own deform net), as ``chip_smoke.py``
reads the CPU's at the card's: the two sides' matmuls round ``Δxy`` apart
in the last bit, and the grid's slope, through which the deform net
learns, jumps at every cell edge of its 16 levels (to resolution 2048):
with each side's own ``Δxy`` the first deform layer's gradient reads
6.3e-4. ``Δxy`` itself is held to JAX's within 1e-5 of its largest
magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_import_scene import TORSO, jax_checkpoint, make_scene

from geneface_tpu.config import Config as JConfig
from geneface_tpu.data.radnerf_dataset import RADNeRFDataset as JDataset
from geneface_tpu.models.radnerf import RADNeRFTorso as JTorso
from geneface_tpu.tasks.radnerf import model_from_cfg as jmodel_from_cfg
from geneface_tpu.tasks.radnerf_torso import RADNeRFTorsoTask as JTorsoTask
from geneface_tpu_torch.convert import flax_path, flax_to_state_dict
from geneface_tpu_torch.models.radnerf import OccupancyState, TorsoOccupancyState
from geneface_tpu_torch.tasks.radnerf_torso import RADNeRFTorsoTask
from geneface_tpu_torch.training.optim import torso_label_fn
from geneface_tpu_torch.utils import torch_import as ti
from geneface_tpu_torch.utils.checkpoint import load_checkpoint

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    scene = make_scene(tmp_path_factory.mktemp("torch_import_torso"), 64)
    root = scene["root"]
    head_dir = str(root / "port_head")
    ti.import_radnerf_checkpoint(scene["src"], scene["cfg"], head_dir, torso=False)
    cfg = dict(scene["cfg"], head_model_dir=head_dir, update_extra_interval=4,
               density_thresh_torso=0.01)
    jstate = jax_checkpoint(str(root / "jax_torso"), cfg, scene["sd"], torso=True)
    jtask = JTorsoTask(JConfig(cfg))  # the parts of build() that the loss reads
    jtask.model = jmodel_from_cfg(JConfig(cfg), JTorso, dtype=jnp.float32, **TORSO)
    jtask.train_ds = JDataset("train", scene["data"], JConfig(cfg), training=True)
    jtask.grid_size = cfg["grid_size"]
    batch = jtask.train_ds[3]
    dbatch = jtask._device_batch(batch, 0)
    dbatch["pose"] = jnp.asarray(batch["pose"])
    rng = jax.random.PRNGKey(3)
    # eager: under jax.jit XLA's CPU compiler moves the torso gradients
    # (tests/test_torch_torso_training.py)
    (jloss, jlosses), jgrads = jax.value_and_grad(
        lambda p: jtask._loss_fn_torso(p, jstate["occ"], jstate["torso_occ"], dbatch, rng, True),
        has_aux=True,
    )(jstate["params"])
    noises = np.asarray(jax.random.uniform(rng, (len(batch["inds"]),)))
    b = jtask._expand_light_batch(dbatch)
    p = jstate["params"]
    t_ind = p["params"]["torso_individual_codes"][min(int(b["idx"]), cfg["individual_embedding_num"] - 1)]
    jdx = np.array(jtask.model.apply(p, b["bg_coords"], b["pose"], t_ind,
                                     method=jtask.model.forward_torso)[2])
    torso_ckpt = ti.import_radnerf_checkpoint(scene["src"], cfg, str(root / "port_torso"))
    return (cfg, load_checkpoint(torso_ckpt)["state"], batch, noises, jdx,
            (jloss, jlosses, jgrads))


def _port_task(cfg, state):
    """The torso task on the imported head (``head_model_dir``), then the
    imported torso checkpoint's parameters and both occupancies."""
    task = RADNeRFTorsoTask(cfg, device="cpu", dtype=torch.float32)
    task.build()
    head = {n: p.detach().clone() for n, p in task.model.named_parameters()
            if not p.requires_grad}
    task.model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in flax_to_state_dict(state["params"]).items()})
    for n, p in task.model.named_parameters():  # the warm start read the same head
        if n in head:
            assert torch.equal(p, head[n]), n
    task.set_occupancy(OccupancyState(*[torch.as_tensor(np.asarray(x)) for x in state["occ"]]))
    task.torso_occ = TorsoOccupancyState(
        *[torch.as_tensor(np.asarray(x), dtype=torch.float32) for x in state["torso_occ"]])
    return task


def test_torso_step_on_the_import_matches_jax(case):
    cfg, state, batch, noises, jdx, (jloss, jlosses, jgrads) = case
    task = _port_task(cfg, state)
    assert task.model.grid_backend == "reference" and task.model.torso_grid_meta.num_levels == 16
    seen = []

    def at_jax_deform(module, inputs, dxy):
        seen.append(dxy.detach().clone())
        return torch.from_numpy(jdx) + (dxy - dxy.detach())

    task.model.torso_deform_net.register_forward_hook(at_jax_deform)
    loss, losses = task.loss_fn(task.device_batch(batch, 0), torch.from_numpy(noises), train=True)
    loss.backward()
    np.testing.assert_allclose(seen[0].numpy(), jdx, rtol=0, atol=1e-5 * np.abs(jdx).max())
    assert float(losses["mean_samples"]) > 0.5  # the head's rays do hit the ball
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    named = dict(task.model.named_parameters())
    n_torso = 0
    for name, want in flax_to_state_dict(jgrads).items():
        got = named[name].grad
        if torso_label_fn("/".join(("params",) + flax_path(name))) == "frozen":
            assert got is None and not np.any(want), name
            continue
        n_torso += 1
        assert got is not None and np.abs(want).max() > 0, name
        err = float(np.linalg.norm(got.numpy() - want) / np.linalg.norm(want))
        assert err <= 1e-4, (name, err)
    assert n_torso == 8  # the grid, the codes, deform x3, canonical x3


def test_torso_steps_keep_the_imported_head_and_render(case):
    cfg, state, batch, _, _, _ = case
    task = _port_task(cfg, state)
    head = {n: p.detach().clone() for n, p in task.model.named_parameters()
            if not p.requires_grad}
    for step in range(2):
        out = task.train_step(batch)
        assert out["occupancy_sweep"] == float(step == 0) and np.isfinite(float(out["total_loss"]))
    for n, p in task.model.named_parameters():
        if n in head:
            assert torch.equal(p, head[n]), n
    img, gt = task.render_full_frame()
    assert img.shape == gt.shape == (64, 64, 3) and np.isfinite(img).all()
