"""One RAD-NeRF head training step under the options the port once
refused, against the JAX task (64² synthetic scene, 256 rays, widths 16;
the ``tests/test_torch_training.py`` config with a hashmap large enough
for a dense level 0, so that ``mixed`` runs both kinds of group):
``grid_compute_dtype`` bf16 with ``grid_bwd_dtype`` bf16, ``mixed`` with
``same``, and ``bound: 2`` (two cascades: the sweep, then the walk instead
of the lattice march).

The JAX gradient is jitted (a first eager gradient of this loss costs ~40 s
here); Adam is left out, since it turns last-bit gradient differences into
parts of ``lr``. Tolerances:
- loss rel 1e-5 (the grid tables' init, U(-1e-4, 1e-4), keeps their
  bfloat16 rounding below the loss's float32 resolution);
- at the bf16 options every gradient within 1e-2·max|g| of JAX's (measured
  1.7e-3, the position grid's hash group: XLA's jitted program keeps the
  backward's products in float32, see ``tests/test_torch_options.py``),
  and the grid tables' gradients closer to JAX's bf16 ones than the port's
  float32 step is;
- at ``bound: 2`` (float32 grids) every gradient within rtol 1e-4 and
  atol 1e-4·max|g| (measured 1.3e-5·max|g|, a table entry summing
  thousands of terms in another order).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneface_tpu.config import Config as JConfig
from geneface_tpu.models.radnerf import RADNeRF as JRADNeRF
from geneface_tpu.tasks.radnerf import RADNeRFTask as JTask
from geneface_tpu.tasks.radnerf import model_from_cfg as jmodel_from_cfg
from geneface_tpu_torch.convert import flax_to_state_dict
from geneface_tpu_torch.models.radnerf import OccupancyState
from geneface_tpu_torch.tasks.radnerf import RADNeRFTask

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.make_synthetic_dataset import make_dataset  # noqa: E402

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)


def tiny_cfg(data_dir, **over):
    cfg = dict(
        data_dir=data_dir, work_dir="",
        cond_type="idexp_lm3d_normalized", cond_win_size=1, smo_win_size=3,
        cond_out_dim=16, with_att=True, bound=1, grid_type="tiledgrid",
        log2_hashmap_size=14, desired_resolution=128, grid_size=32,
        num_layers_ambient=2, hidden_dim_ambient=16, num_layers_sigma=2,
        hidden_dim_sigma=16, geo_feat_dim=16, num_layers_color=2,
        hidden_dim_color=16, individual_embedding_num=16,
        individual_embedding_dim=4, n_rays=256, max_steps=8,
        update_extra_interval=4, density_thresh=10, dt_gamma=1.0 / 256,
        near=0.3, far=0.9, min_near=0.05, lr=5e-3, scheduler="exponential",
        max_updates=12, finetune_lips=False, lambda_weights_entropy=1e-4,
        lambda_ambient=0.1, native_loader=False, seed=0,
    )
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_options_steps")
    make_dataset(str(d), n_frames=12, hw=64)
    return str(d)


def _steps(cfg, port_dtypes):
    """The JAX task's jitted loss and gradients, and the port's task's
    (at each ``(grid_compute_dtype, grid_bwd_dtype)`` of ``port_dtypes``),
    on the same parameters, occupancy (one JAX sweep), batch and noise."""
    jtask = JTask(JConfig(cfg))
    jstate = jtask.build()
    params = jstate["params"]
    cond = jnp.asarray(jtask.train_ds.conds[:3])
    occ = jtask._occ_update_fn(params, jstate["occ"], cond, jax.random.PRNGKey(1))
    batch = jtask.train_ds[2]
    jtask.model = jmodel_from_cfg(JConfig(cfg), JRADNeRF, dtype=jnp.float32)
    dbatch = jtask._device_batch(batch, 1000)
    rng = jax.random.PRNGKey(3)
    (jloss, jlosses), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtask._loss_fn(p, occ, dbatch, rng, train=True), has_aux=True))(params)
    noises = torch.from_numpy(np.array(jax.random.uniform(rng, (len(batch["inds"]),))))
    ports = []
    for compute, bwd in port_dtypes:
        task = RADNeRFTask(dict(cfg, grid_compute_dtype=compute, grid_bwd_dtype=bwd),
                           device="cpu", dtype=torch.float32)
        task.build()
        task.model.load_state_dict(
            {k: torch.from_numpy(v) for k, v in flax_to_state_dict(params).items()})
        task.set_occupancy(OccupancyState(*[torch.from_numpy(np.array(x)) for x in occ]))
        loss, losses = task.loss_fn(task.device_batch(batch, 1000), noises, train=True)
        loss.backward()
        assert float(losses["mean_samples"]) == float(jlosses["mean_samples"]) > 1.0
        ports.append((task, float(loss.detach()),
                      {n: p.grad.numpy() for n, p in task.model.named_parameters()}))
    return float(jloss), flax_to_state_dict(jgrads), np.asarray(occ.occ_grid), ports


@pytest.mark.parametrize("compute,bwd", [("bf16", "bf16"), ("mixed", "same")])
def test_head_step_at_grid_options_matches_jax(synth_dir, compute, bwd):
    cfg = tiny_cfg(synth_dir, grid_compute_dtype=compute, grid_bwd_dtype=bwd)
    jloss, jgrads, _, ports = _steps(cfg, [(compute, bwd), ("f32", "same")])
    (task, loss, grads), (_, _, grads32) = ports
    meta = task.model.pos_fused_meta
    assert {"dense", "hash"} <= set(meta.modes)
    assert (meta.compute, meta.bwd_compute) == (compute, bwd)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert grads.keys() == jgrads.keys()
    for name, want in jgrads.items():
        scale = float(np.abs(want).max())
        assert scale > 0, name
        assert np.abs(grads[name] - want).max() <= 1e-2 * scale, name
    for name in jgrads:
        if "embeddings.group" in name:
            err = np.linalg.norm(grads[name] - jgrads[name])
            assert err < np.linalg.norm(grads32[name] - jgrads[name]), name


def test_bound_two_step_takes_the_walk_and_matches_jax(synth_dir):
    cfg = tiny_cfg(synth_dir, bound=2)
    jloss, jgrads, jocc, [(task, loss, grads)] = _steps(cfg, [("f32", "same")])
    assert jocc.shape[0] == 2 and jocc[1].any()  # the sweep filled both cascades
    assert task.occ.occ_grid.shape[0] == 2 and task._occ_view.blocks is None
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for name, want in jgrads.items():
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(grads[name], want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)
