"""One training step of an imported GeneFace checkpoint under the keys of
``egs/datasets/videos/May/lm3d_radnerf_import.yaml`` (the reference grid at
16 × 2, the walk, the padded slab) against the JAX task on a 64² scene,
both sides on the JAX rays and march jitter: loss within 1e-5 relative and
every gradient within rtol 1e-4, atol 1e-5·max|g| at float32 MLPs, as
``tests/test_torch_training.py`` holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_import_scene import jax_checkpoint, make_scene

from geneface_tpu.config import Config as JConfig
from geneface_tpu.models.radnerf import RADNeRF as JRADNeRF
from geneface_tpu.tasks.radnerf import RADNeRFTask as JTask
from geneface_tpu.tasks.radnerf import model_from_cfg as jmodel_from_cfg
from geneface_tpu_torch.convert import flax_to_state_dict
from geneface_tpu_torch.tasks.radnerf import RADNeRFTask
from geneface_tpu_torch.utils import torch_import as ti
from geneface_tpu_torch.utils.checkpoint import get_last_checkpoint, load_checkpoint


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_scene(tmp_path_factory.mktemp("torch_import_training"), 64)


@pytest.fixture(scope="module")
def step_case(scene):
    """The JAX task and the port's task on the imported head, the batch of
    frame 2 and the JAX rays."""
    root = scene["root"]
    cfg = dict(scene["cfg"], work_dir=str(root / "train_jax"))
    jtask = JTask(JConfig(cfg))
    jstate = jtask.build()
    jtask.model = jmodel_from_cfg(JConfig(cfg), JRADNeRF, dtype=jnp.float32)
    state = jax_checkpoint(str(root / "train_jax"), cfg, scene["sd"], torso=False,
                           template=jstate["params"])
    batch = jtask.train_ds[2]
    return cfg, jtask, state["params"], state["occ"], batch


def test_train_step_matches_jax(scene, step_case):
    cfg, jtask, params, occ, batch = step_case
    step = 1000
    dbatch = jtask._device_batch(batch, step)
    rng = jax.random.PRNGKey(3)
    (jloss, jlosses), jgrads = jax.value_and_grad(
        lambda p: jtask._loss_fn(p, occ, dbatch, rng, train=True), has_aux=True
    )(params)
    jrays = jtask._expand_light_batch(dbatch)

    work = str(scene["root"] / "train_port")
    ti.import_radnerf_checkpoint(scene["src"], cfg, work, torso=False)
    task = RADNeRFTask(dict(cfg, work_dir=work), device="cpu", dtype=torch.float32)
    task.build()
    task.restore_state(load_checkpoint(get_last_checkpoint(work))["state"])
    tb = task.device_batch(batch, step)
    # the same rays on both sides (the ray rebuilds differ in the last bit)
    tb["rays_o"] = torch.from_numpy(np.array(jrays["rays_o"]))
    tb["rays_d"] = torch.from_numpy(np.array(jrays["rays_d"]))
    noises = torch.from_numpy(np.asarray(jax.random.uniform(rng, (len(batch["inds"]),))))
    kw = task.render_kwargs()
    assert kw["lattice_K"] is None and not kw["mean_samples_per_ray"]
    loss, losses = task.loss_fn(tb, noises, train=True)
    loss.backward()
    assert "march_span" not in losses
    assert float(losses["mean_samples"]) == pytest.approx(float(jlosses["mean_samples"]))
    assert float(jlosses["mean_samples"]) > 0.5  # the rays do hit the occupied ball
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    named = dict(task.model.named_parameters())
    for name, want in flax_to_state_dict(jgrads).items():
        got = named[name].grad
        assert got is not None, name
        scale = float(np.abs(want).max())
        assert scale > 0, name
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * scale, err_msg=name)
    # the padded slab retunes nothing
    task.maybe_retune_capacity({k: v.detach() for k, v in losses.items()})
    assert task._spr_bucket is None and task._latk_bucket is None


