"""The RAD-NeRF torso's training step split over two gloo ranks on the CPU
(``tests/torch_ddp_helpers.py``) against the same step on one rank and
against the JAX torso loss on a two-device mesh, on the tiny config of
``tests/test_torch_torso_training.py`` (64² frames, 512 rays, the head's
occupancy a ball, a planted torso occupancy).

Tolerances:
- two ranks against one (``train_step``: the torso sweep, the split batch,
  the head's jitter drawn globally, the gradient average, Adam): loss rel
  1e-6, every torso gradient within relative L2 1e-5, the torso occupancy
  after the sweep bit-equal across the ranks and to the one-rank run's;
- two ranks against JAX (its eager ``value_and_grad`` — under ``jax.jit``
  XLA's CPU compiler puts the torso grid's gradients 5-13% off, see
  ``tests/test_torch_torso_training.py`` — of the torso loss on the batch
  sharded over ``make_mesh(devices=jax.devices()[:2])``, ``pose``
  replicated, the same parameters, occupancy and march noise): the bounds
  of ``tests/test_torch_torso_training.py``, loss rel 1e-5 and every torso
  gradient within relative L2 1e-4.
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
from geneface_tpu.models.radnerf import RADNeRFTorso as JTorso
from geneface_tpu.models.radnerf.renderer import OccupancyState as JOcc
from geneface_tpu.models.radnerf.renderer import TorsoOccupancyState as JTorsoOcc
from geneface_tpu.parallel import make_mesh as jmake_mesh
from geneface_tpu.tasks.radnerf import model_from_cfg as jmodel_from_cfg
from geneface_tpu.tasks.radnerf_torso import RADNeRFTorsoTask as JTorsoTask
from geneface_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import torch_ddp_helpers as ddp  # noqa: E402
from test_torch_torso_training import _ball, tiny_cfg  # noqa: E402
from tools.make_synthetic_dataset import make_dataset  # noqa: E402

torch.set_num_threads(1)


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The scene, a state (the port's seeded parameters with the head's
    density lifted, an occupancy ball, a planted torso occupancy), two
    batches, the JAX noise, and the two-rank results."""
    root = tmp_path_factory.mktemp("torch_ddp_torso")
    data = str(root / "data")
    make_dataset(data, n_frames=8, hw=64)
    cfg = tiny_cfg(data, n_rays=512)
    task = ddp.make_task("torso", cfg)
    task.build()
    params = state_dict_to_flax(task.model.state_dict())
    params["params"]["sigma_net"]["Dense_1"]["kernel"][:, 0] += 0.5
    H = cfg["grid_size"]
    dens, occ = _ball(H)
    g = np.zeros((H, H), np.float32)
    g[:, H // 2 + 1:] = 0.5
    state = {"params": params, "occ": (dens, occ, np.float32(0.0)),
             "torso_occ": (g.reshape(-1), np.float32(g.mean()))}
    batches = [task.train_ds[3], task.train_ds[5]]
    rng = jax.random.PRNGKey(3)
    noises = np.asarray(jax.random.uniform(rng, (len(batches[0]["inds"]),)))
    cases = {
        "steps": dict(kind="torso", cfg=cfg, batches=batches, state=state),
        "grads": dict(kind="torso", cfg=cfg, batch=batches[0], state=state, noises=noises,
                      step=0, fn="grads"),
    }
    out = ddp.run_ranks("steps", {"cases": cases}, 2, str(root / "ranks"))
    cases["grads"].pop("fn")
    return dict(cfg=cfg, data=data, state=state, batch=batches[0], rng=rng, cases=cases,
                out=out)


def test_two_rank_torso_steps_match_one_rank(case):
    one = ddp.step_result(**case["cases"]["steps"])
    two, other = case["out"][0]["steps"], case["out"][1]["steps"]
    assert one["losses"][0]["occupancy_sweep"] == 1.0
    assert one["losses"][0]["mean_samples"] > 1.0  # the head's rays hit the ball
    for s, (l1, l2) in enumerate(zip(one["losses"], two["losses"])):
        for k in ("total_loss", "torso_mse_loss", "torso_weights_entropy_loss"):
            np.testing.assert_allclose(l2[k], l1[k], rtol=1e-6, err_msg=f"{k} @ {s}")
        assert set(two["grads"][s]) == set(one["grads"][s])
        for name, g in one["grads"][s].items():
            err = rel_l2(two["grads"][s][name], g)
            assert err <= 1e-5, (name, err)
            np.testing.assert_array_equal(other["grads"][s][name], two["grads"][s][name])
    for a, b, c in zip(two["torso_occ"], other["torso_occ"], one["torso_occ"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_two_rank_torso_loss_matches_one_rank_and_jax_mesh(case):
    two = case["out"][0]["grads"]
    one = ddp.loss_grads(**case["cases"]["grads"])
    np.testing.assert_allclose(two["losses"]["total_loss"], one["losses"]["total_loss"],
                               rtol=1e-6)
    for name, g in one["grads"].items():
        assert rel_l2(two["grads"][name], g) <= 1e-5, name

    cfg, state = case["cfg"], case["state"]
    jtask = JTorsoTask(JConfig(cfg))  # the parts of build() that the loss reads
    jtask.model = jmodel_from_cfg(JConfig(cfg), JTorso, dtype=jnp.float32, torso_head_aware=True)
    jtask.train_ds = JDataset("train", case["data"], JConfig(cfg), training=True)
    jtask.grid_size = int(cfg["grid_size"])
    jtask.mesh = jmake_mesh(devices=jax.devices()[:2])
    batch = case["batch"]
    dbatch = jtask._device_batch(batch, 0)
    dbatch.update(jtask.place_batch({"pose": batch["pose"]}))
    assert len(dbatch["inds"].sharding.device_set) == 2
    assert dbatch["pose"].sharding.is_fully_replicated
    params = jax.tree_util.tree_map(jnp.asarray, state["params"])
    (jl, jls), jg = jax.value_and_grad(
        lambda p: jtask._loss_fn_torso(
            p, JOcc(*map(jnp.asarray, state["occ"])),
            JTorsoOcc(*map(jnp.asarray, state["torso_occ"])), dbatch, case["rng"], True),
        has_aux=True,
    )(params)
    np.testing.assert_allclose(two["losses"]["total_loss"], float(jl), rtol=1e-5)
    np.testing.assert_allclose(two["losses"]["torso_mse_loss"], float(jls["torso_mse_loss"]),
                               rtol=1e-5)
    want = flax_to_state_dict(jg)
    assert len(two["grads"]) == 15  # grid x2, codes, deform x3, canonical x3, head-aware x6
    for name, g in two["grads"].items():
        err = rel_l2(g, want[name])
        assert err <= 1e-4, (name, err)
