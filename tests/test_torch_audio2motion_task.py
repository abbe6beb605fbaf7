"""The VAE training task (``VAESyncAudio2MotionTask``) against the JAX
task on the CPU (the pitch VAE's training forward and gradients are held
in ``test_torch_vae_train.py``, its task through ``tasks/run.py`` in
``test_torch_audio_train_run.py``).

- One step with the sync term on (``enable_sync`` True, ``lambda_sync``
  1) on the same batch, positive clips, parameters and posterior noise
  (JAX draws it from ``split(rng)[0]``): every loss (MSE, continuity, KL,
  sync, total) within rtol 1e-4 of the JAX task's jitted step.
- The sync gate: both tasks turn ``enable_sync`` on at the first
  validation whose sync loss is ≤ 0.75, and keep it.
- ``enable_sync`` survives a checkpoint: a ``Trainer`` run whose
  validation turned it on writes it, and a fresh task restores it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geneface_tpu.tasks import audio2motion as jtask
from geneface_tpu_torch.convert import flax_variables, load_flax_variables
from geneface_tpu_torch.tasks import audio2motion as task
from geneface_tpu_torch.training.trainer import Trainer
from geneface_tpu_torch.utils.checkpoint import get_last_checkpoint, load_checkpoint
from tools.make_synthetic_lrs3 import make_lrs3
from torch_audio_helpers import perturbed

@pytest.fixture(scope="module")
def lrs3_dir(tmp_path_factory):
    return make_lrs3(str(tmp_path_factory.mktemp("lrs3")), n_train=6, n_val=2)


def _cfg(data_dir, **over):
    cfg = dict(data_dir=data_dir, seed=4, lr=1e-3, scheduler="none", max_tokens=1000,
               syncnet_num_samples_per_batch=8, lambda_kl=0.4, lambda_sync=1.0,
               syncnet_work_dir="", optimizer_adam_beta1=0.9, optimizer_adam_beta2=0.999)
    cfg.update(over)
    return cfg


def _jax_task(jcls, t):
    """The JAX task with its modules set as its ``build`` sets them (its
    ``build`` spends most of a minute in eager flax inits), on the port's
    seeded frozen SyncNet."""
    from geneface_tpu.models.syncnet import LandmarkHubertSyncNet as JSyncNet
    from geneface_tpu.training.optim import finalize_optimizer

    jt = jcls(t.cfg)
    jt.model = jt.make_model()
    jt.train_ds = t.train_ds
    jt.np_rng = np.random.RandomState(t.cfg["seed"])
    jt.clip_batch = t.clip_batch
    jt.enable_sync = False
    jt.syncnet = JSyncNet(lm_dim=60)
    jt.sync_params = jax.tree_util.tree_map(jnp.asarray, flax_variables(t.syncnet))
    jt.tx = finalize_optimizer(optax.adam(t.cfg["lr"], b1=0.9, b2=0.999), t.cfg)
    jt._build_jits()
    return jt


def test_one_step_with_sync_matches_jax(lrs3_dir):
    jcls, cls = jtask.VAESyncAudio2MotionTask, task.VAESyncAudio2MotionTask
    t = cls(_cfg(lrs3_dir), device="cpu")
    t.build()
    v = perturbed(flax_variables(t.model), seed=1, scale=0.02)
    out = v["params"]["vae"]["encoder"]["out"]  # a trained posterior's |logs_q| range
    out["kernel"], out["bias"] = 0.05 * out["kernel"], 0.05 * out["bias"]
    load_flax_variables(t.model, v)
    jt = _jax_task(jcls, t)
    t.enable_sync = jt.enable_sync = True
    batch = next(t.train_batches(0))
    dev, clip_idx = jt._prep(batch)
    rng = jax.random.PRNGKey(5)
    _, _, jlosses = jt._train_step_fn(jax.tree_util.tree_map(jnp.asarray, v),
                                      jt.tx.init(v), dev, clip_idx, rng, jnp.float32(1.0))
    tdev, tidx = t.prep(batch)
    for a, b in zip(tidx, clip_idx):  # the same RandomState draws
        np.testing.assert_array_equal(a, np.asarray(b))
    B, T = batch["y_mask"].shape
    noise = np.asarray(jax.random.normal(jax.random.split(rng)[0], t.model.noise_shape(B, T)))
    assert t.sync_weight() == 1.0
    t.optimizer.zero_grad()
    total, losses = t.loss_fn(tdev, tidx, torch.from_numpy(noise), t.sync_weight())
    total.backward()
    t.optimizer.step()
    assert sorted(losses) == sorted(jlosses)
    for k, want in jlosses.items():
        np.testing.assert_allclose(float(losses[k]), float(want), rtol=1e-4, err_msg=k)
    assert float(losses["sync"]) > 0 and float(losses["kl"]) != 0
    assert all(p.grad is not None and bool((p.grad != 0).any())
               for n, p in t.model.named_parameters() if "key_proj" not in n)
    assert int(t.optimizer.count) == 1


def test_sync_gate_matches_jax(lrs3_dir):
    t = task.VAESyncAudio2MotionTask(_cfg(lrs3_dir), device="cpu")
    t.build()
    jt = _jax_task(jtask.VAESyncAudio2MotionTask, t)
    batch = next(t.val_batches())
    seq = [0.9, 0.751, 0.75, 0.9]
    real = t.loss_fn

    def scripted(values, fn):
        it = iter(values)

        def patched(*a, **k):
            total, losses = fn(*a, **k)
            return total, dict(losses, sync=torch.tensor(next(it)))
        return patched

    t.loss_fn = scripted(seq, real)
    jseq = iter(seq)
    jt._val_step_fn = lambda *a: {"sync": jnp.float32(next(jseq))}  # the gate is the host's
    got, want = [], []
    for _ in seq:
        t.val_step(batch)
        jt.val_step({"params": None}, batch, jax.random.PRNGKey(0))
        got.append(t.enable_sync)
        want.append(jt.enable_sync)
    assert got == want == [False, False, True, True]
    assert t.sync_weight() == 1.0


def test_enable_sync_survives_a_checkpoint(lrs3_dir, tmp_path):
    cfg = _cfg(lrs3_dir, work_dir=str(tmp_path / "vae"), max_updates=2, val_check_interval=2,
               tb_log_interval=1, num_sanity_val_steps=0, eval_max_batches=1)
    t = task.VAESyncAudio2MotionTask(cfg, device="cpu")
    real_val = task.VAESyncAudio2MotionTask.val_step

    def low_sync_val(self, batch):
        losses = real_val(self, batch)
        self.enable_sync = True  # as a validation with sync <= 0.75 would
        return losses

    t.val_step = low_sync_val.__get__(t)
    assert Trainer(t).fit() == 2
    ckpt = load_checkpoint(get_last_checkpoint(cfg["work_dir"]))
    assert ckpt["extra"] == {"enable_sync": True}
    assert sorted(ckpt["state"]) == ["opt_state", "params"]
    fresh = task.VAESyncAudio2MotionTask(dict(cfg, max_updates=3), device="cpu")
    seen = {}
    real_restore = fresh.on_restore

    def record(extra):
        real_restore(extra)
        seen["enable_sync"] = fresh.enable_sync

    fresh.on_restore = record
    assert Trainer(fresh).fit() == 3
    assert seen == {"enable_sync": True}
    assert os.path.exists(os.path.join(cfg["work_dir"], "model_ckpt_steps_3.ckpt"))
