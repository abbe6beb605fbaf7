"""One step of the port's vanilla NeRF tasks against the JAX tasks on a
tiny config (32² synthetic scene, 96 rays, hidden 32, ``cond_dim`` 16, 8+8
samples): the head step in the warm start and with attention, and the
torso step on a frozen JAX-written head.

Each step is held as the port's other step tests hold theirs: its loss
and every parameter's gradient against JAX's eager ``value_and_grad`` on
the same batch, parameters and draws (the jitter and importance draws taken from
the JAX step's key, and the JAX renders fed the port's importance samples:
see ``check_step``), and the update against optax applied to the port's
own gradient (two Adam groups, ``att`` ×5, eps 1e-8). The frozen head stays
bit-identical through the torso step.

Tolerances: loss within 1e-5 relative; gradients within a relative L2 error
of 1e-4 per leaf; the update within atol 1e-7 + rtol 1e-6 of optax's. The
JAX side replays the port's importance samples and backbone ReLU decisions
(see ``check_step``), which otherwise fall apart on last-bit differences.
"""

import os
import sys

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geneface_tpu.config import Config as JConfig
from geneface_tpu.models.nerf import backbone as jbackbone
from geneface_tpu.ops import volume as jvol
from geneface_tpu.tasks.lm3d_nerf import Lm3dNeRFTask as JTask
from geneface_tpu.tasks.lm3d_nerf import Lm3dNeRFTorsoTask as JTorsoTask
from geneface_tpu.utils.checkpoint import save_checkpoint as jsave
from geneface_tpu_torch.convert import nerf_flax_to_state_dict, nerf_state_dict_to_flax
from geneface_tpu_torch.ops import volume as tvol
from geneface_tpu_torch.tasks import lm3d_nerf as tlm3d
from geneface_tpu_torch.tasks.lm3d_nerf import Lm3dNeRFTask, Lm3dNeRFTorsoTask

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.make_synthetic_dataset import make_dataset  # noqa: E402

torch.set_num_threads(1)

LOSS = 1e-5
GRAD = 1e-4


def tiny_cfg(data_dir, **over):
    cfg = dict(
        data_dir=data_dir, cond_type="idexp_lm3d_normalized", cond_win_size=1, smo_win_size=3,
        cond_dim=16, hidden_size=32, with_att=True, use_window_cond=True, no_smo_iterations=2,
        n_rays=96, in_rect_percent=0.9, n_samples_per_ray=8, n_samples_per_ray_fine=8,
        near=0.3, far=0.9, lr=5e-3, scheduler="exponential", seed=0,
    )
    cfg.update(over)
    return cfg


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def leaves(tree):
    return {jax.tree_util.keystr(p): np.array(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def jax_draws(key, n, cfg):
    """The jitter and importance draws of JAX's ``render_rays`` at ``key``."""
    _, k_strat, _, k_pdf, _ = jax.random.split(key, 5)
    return {"t_rand": torch.tensor(np.array(jax.random.uniform(
                k_strat, (n, cfg["n_samples_per_ray"])))),
            "u": torch.tensor(np.array(jax.random.uniform(
                k_pdf, (n, cfg["n_samples_per_ray_fine"]))))}


def seeded_params(jmodel, cond, seed):
    """JAX-initialised parameters with non-zero biases, numpy leaves; the
    sigma biases (``Dense_8``) at 3 keep the fields translucent (at the bare
    init most sigmas are negative, ReLU cuts them, and every gradient
    vanishes into rounding)."""
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(cond), jnp.zeros((4, 8, 3)),
                         jnp.zeros((4, 3)), method=jmodel.init_all)
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda v: np.array(v) + (0.05 * rng.randn(*v.shape).astype(np.float32)
                                 if v.ndim == 1 else 0), params)
    for net in ("model_coarse", "model_fine"):
        params["params"][net]["Dense_8"]["bias"][:] = 3.0
    return params


def check_step(task, jtask, params, batch, key, with_att, train_params, monkeypatch):
    """Hold the port's step at ``params`` to JAX's: loss, gradients, and
    the update against optax on the port's gradient. The JAX renders take
    the port's importance samples (``sample_pdf`` patched in the JAX
    module): the two cumsums of the CDF round apart in the last bits, and
    a last-bit move of a fine position moves the 2⁹ frequency band by
    ~3e-5 (``sample_pdf`` itself is held in ``tests/test_torch_volume.py``).
    The JAX backbones take the port's ReLU decisions (:class:`ReluDecisions`)."""
    cfg = task.cfg
    model = task.trainable()
    task.optimizer.zero_grad(set_to_none=True)
    port_samples = []

    def recording(*args, **kw):
        out = tvol.render_rays(*args, **kw)
        port_samples.append(out["z_samples"])
        return out

    monkeypatch.setattr(tlm3d, "render_rays", recording)
    # the head (frozen in the torso task), then the trained model: JAX's order
    decisions = ReluDecisions(*({id(m): m for m in (task.model, model)}.values()))
    total, losses = task.loss_fn(task.device_batch(batch),
                                 jax_draws(key, batch["rays_o"].shape[0], cfg), with_att)
    total.backward()
    decisions.remove()
    replay = [jnp.asarray(z.numpy()) for z in port_samples]
    monkeypatch.setattr(jvol, "sample_pdf", lambda *a, **kw: replay.pop(0))
    monkeypatch.setattr(jbackbone, "nn", decisions)
    jbatch = {k: jnp.asarray(batch[k]) for k in task.data_batch_keys}
    (jl, _), jg = jax.value_and_grad(
        lambda p: jtask._loss_fn(p, jbatch, key, True, with_att), has_aux=True)(params)
    assert not replay and not decisions.masks
    assert abs(total.item() - float(jl)) <= LOSS * abs(float(jl))
    # a parameter the loss does not reach (the attention net in the warm
    # start) has no gradient here and a zero one in JAX
    grads = nerf_state_dict_to_flax({n: torch.zeros_like(p) if p.grad is None else p.grad
                                     for n, p in model.named_parameters()})
    want, got = leaves(jg), leaves(grads)
    assert set(want) == set(got)
    for k in want:
        assert rel_l2(got[k], want[k]) < GRAD, (k, rel_l2(got[k], want[k]))
    # the update: optax (the JAX task's transform) on the port's own gradient
    tx = jtask.tx
    upd, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), tx.init(train_params),
                       train_params)
    ref = leaves(optax.apply_updates(train_params, upd))
    task.optimizer.step()
    now = leaves(nerf_state_dict_to_flax(model.state_dict()))
    for k in ref:
        np.testing.assert_allclose(now[k], ref[k], atol=1e-7, rtol=1e-6, err_msg=k)
    return losses


class ReluDecisions:
    """The port's backbone ReLU decisions, recorded by forward hooks in call
    order, and a stand-in for ``flax.linen`` in the JAX backbone's module
    whose ``relu`` replays them (``where(port's x > 0, x, 0)``): a
    pre-activation within rounding of zero otherwise takes the other side
    in one framework on some sample (1.6e-7 of its layer's largest on the
    torso step's batch here), and that sample's whole backward moves."""

    def __init__(self, *models):
        self.masks, self.handles = [], []
        for model in models:
            for net in ("model_coarse", "model_fine"):
                backbone = getattr(model, net)
                skip = (backbone.num_density_linears, len(backbone.layers) - 1)  # sigma, rgb
                for i, layer in enumerate(backbone.layers):
                    if i not in skip:
                        self.handles.append(layer.register_forward_hook(self.record))

    def record(self, _module, _inp, out):
        self.masks.append(out.detach().numpy() > 0)

    def remove(self):
        for h in self.handles:
            h.remove()

    def relu(self, x):
        mask = self.masks.pop(0)
        assert mask.shape == x.shape
        return jnp.where(mask, x, 0.0)

    def __getattr__(self, name):
        return getattr(flax.linen, name)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("nerf_step"))
    make_dataset(d, n_frames=8, hw=32)
    return d


@pytest.mark.parametrize("with_att", [False, True], ids=["warm_start", "attention"])
def test_head_step_matches_jax(synth, with_att, monkeypatch):
    cfg = tiny_cfg(synth)
    jtask = JTask(JConfig(cfg))
    jtask.build()
    task = Lm3dNeRFTask(cfg, device="cpu")
    task.build()
    params = seeded_params(jtask.model, task.train_ds.conds[:3], 1)
    task.model.load_state_dict({k: torch.as_tensor(v)
                                for k, v in nerf_flax_to_state_dict(params).items()})
    task._step = 5 if with_att else 0
    assert task.with_att() == with_att
    batch = task.train_ds[3]
    losses = check_step(task, jtask, params, batch, jax.random.PRNGKey(3), with_att, params,
                        monkeypatch)
    assert {"mse_loss", "mse_loss_coarse", "total_loss", "psnr"} == set(losses)


def test_torso_step_matches_jax(synth, tmp_path, monkeypatch):
    """The torso step on a JAX-written head checkpoint: the head renders
    unjittered under no gradient, the torso with the JAX step's draws."""
    head_dir = str(tmp_path / "head")
    cfg = tiny_cfg(synth, head_model_dir=head_dir, use_color=True, no_smo_iterations=0)
    jtask = JTorsoTask(JConfig(cfg))
    head = seeded_params(jtask.make_model(), np.zeros((3, 1, 204), np.float32), 2)
    jsave(os.path.join(head_dir, "model_ckpt_steps_7.ckpt"),
          {"state": {"params": head}, "step": 7})
    jtask.build()  # reads the head checkpoint
    task = Lm3dNeRFTorsoTask(cfg, device="cpu")
    task.build()
    head_before = {k: v.clone() for k, v in task.model.state_dict().items()}
    for k, v in nerf_flax_to_state_dict(head).items():
        assert torch.equal(head_before[k], torch.as_tensor(v)), k
    params = seeded_params(jtask.torso_model, task.train_ds.conds[:3], 3)
    task.torso_model.load_state_dict({k: torch.as_tensor(v)
                                      for k, v in nerf_flax_to_state_dict(params).items()})
    batch = task.train_ds.get_torso_item(2)
    losses = check_step(task, jtask, params, batch, jax.random.PRNGKey(4), True, params,
                        monkeypatch)
    assert {"com_mse_loss", "com_mse_loss_coarse", "total_loss", "com_psnr"} == set(losses)
    for k, v in task.model.state_dict().items():
        assert torch.equal(v, head_before[k]), k
    assert all(p.grad is None for p in task.model.parameters())
