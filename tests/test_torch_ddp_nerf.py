"""The vanilla NeRF head step (``Lm3dNeRFTask``) split over two gloo ranks
on the CPU (``tests/torch_ddp_helpers.py``) against the same step on one
rank and against the JAX task's loss on a two-device mesh, on the tiny
config of ``tests/test_torch_nerf_training.py`` (32² frames, 96 rays,
hidden 32, 8+8 samples).

Tolerances:
- two ranks against one (``train_step`` in the warm start, then with
  attention: the split rays, ``t_rand`` and ``u`` drawn at the global ray
  count, the gradient average, Adam): loss rel 1e-6, every gradient within
  relative L2 1e-5, the two ranks' gradients equal;
- two ranks against the JAX loss with its batch sharded over
  ``make_mesh(devices=jax.devices()[:2])`` (the task's ``place_batch``),
  JAX's draws on both sides: the bounds of
  ``tests/test_torch_nerf_training.py`` (loss rel 1e-5, gradients
  relative L2 1e-4), the JAX side replaying the ranks' importance samples
  and backbone ReLU decisions joined in rank order (the two frameworks'
  cumsums of the PDF and ReLUs within rounding of zero part otherwise).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneface_tpu.config import Config as JConfig
from geneface_tpu.models.nerf import backbone as jbackbone
from geneface_tpu.ops import volume as jvol
from geneface_tpu.parallel import make_mesh as jmake_mesh
from geneface_tpu.tasks.lm3d_nerf import Lm3dNeRFTask as JTask
from geneface_tpu_torch.convert import nerf_state_dict_to_flax
from geneface_tpu_torch.data.nerf_dataset import NeRFDataset
from geneface_tpu_torch.tasks.lm3d_nerf import Lm3dNeRFTask

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import torch_ddp_helpers as ddp  # noqa: E402
from test_torch_nerf_training import (  # noqa: E402
    GRAD,
    LOSS,
    ReluDecisions,
    jax_draws,
    leaves,
    rel_l2,
    seeded_params,
    tiny_cfg,
)
from tools.make_synthetic_dataset import make_dataset  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_ddp_nerf"))
    make_dataset(d, n_frames=8, hw=32)
    return d


def test_two_rank_nerf_steps_match_one_rank(synth, tmp_path):
    cfg = tiny_cfg(synth)
    ds = NeRFDataset("train", synth, cfg, training=True)
    case = dict(kind="nerf", cfg=cfg, batches=[ds[0], ds[3]], task_step=1)
    r0, r1 = (r["nerf"] for r in ddp.run_ranks("steps", {"cases": {"nerf": case}}, 2,
                                              str(tmp_path)))
    one = ddp.step_result(**case)
    for s, (l1, l2) in enumerate(zip(one["losses"], r0["losses"])):
        for k in ("total_loss", "mse_loss", "mse_loss_coarse"):
            np.testing.assert_allclose(l2[k], l1[k], rtol=1e-6, err_msg=f"{k} @ {s}")
        assert set(r0["grads"][s]) == set(one["grads"][s])
        for name, g in one["grads"][s].items():
            assert rel_l2(r0["grads"][s][name], g) <= 1e-5, (s, name)
            np.testing.assert_array_equal(r1["grads"][s][name], r0["grads"][s][name])
    # the warm start, then the attention net's first step
    assert not any("att" in n for n in one["grads"][0])
    assert any("att" in n for n in one["grads"][1])


def test_two_rank_nerf_loss_matches_jax_mesh_step(synth, tmp_path, monkeypatch):
    """Two ranks' loss and averaged gradient (with attention) against the
    JAX loss on the batch placed over a two-device mesh, with JAX's draws
    on both sides and the ranks' fine samples and ReLU decisions, joined in
    rank order, replayed on the JAX side (``check_step``'s replay)."""
    cfg = tiny_cfg(synth)
    jtask = JTask(JConfig(cfg))
    jtask.build()
    jtask.mesh = jmake_mesh(devices=jax.devices()[:2])
    task = Lm3dNeRFTask(cfg, device="cpu")
    task.build()
    params = seeded_params(jtask.model, task.train_ds.conds[:3], 1)
    batch = task.train_ds[3]
    key = jax.random.PRNGKey(3)
    noise = {k: v.numpy() for k, v in jax_draws(key, len(batch["rays_o"]), cfg).items()}
    case = dict(fn="nerf", cfg=cfg, params=params, batch=batch, noise=noise, step=5)
    r0, r1 = (r["nerf"] for r in ddp.run_ranks("steps", {"cases": {"nerf": case}}, 2,
                                              str(tmp_path)))
    assert r0["losses"] == r1["losses"]
    replay = [jnp.asarray(np.concatenate([a, b])) for a, b in zip(r0["samples"], r1["samples"])]
    decisions = ReluDecisions()
    decisions.masks = [np.concatenate([a, b]) for a, b in zip(r0["masks"], r1["masks"])]
    monkeypatch.setattr(jvol, "sample_pdf", lambda *a, **kw: replay.pop(0))
    monkeypatch.setattr(jbackbone, "nn", decisions)
    jbatch = jtask.place_batch({k: jnp.asarray(batch[k]) for k in task.batch_keys})
    assert len(jbatch["rays_o"].sharding.device_set) == 2
    assert jbatch["cond_wins"].sharding.is_fully_replicated
    (jl, _), jg = jax.value_and_grad(
        lambda p: jtask._loss_fn(p, jbatch, key, True, True), has_aux=True)(params)
    assert not replay and not decisions.masks
    assert abs(r0["losses"]["total_loss"] - float(jl)) <= LOSS * abs(float(jl))
    want = leaves(jg)
    got = leaves(nerf_state_dict_to_flax({n: torch.as_tensor(g) for n, g in r0["grads"].items()}))
    assert set(want) == set(got)
    for k in want:
        assert rel_l2(got[k], want[k]) < GRAD, (k, rel_l2(got[k], want[k]))
