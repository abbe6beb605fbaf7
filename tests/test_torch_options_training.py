"""The training options the port once refused, against the JAX package on
the CPU: RMSprop under ``accumulate_grad_batches: 2`` (the post-net's
``apply_if_finite(MultiSteps(rmsprop))``), SyncNet trained at
``syncnet_norm: bn``, the TensorBoard event files, and the stage-A tasks
under a mesh of two gloo ranks.

Tolerances:
- RMSprop with accumulation against optax over 5 micro-steps (one
  non-finite, skipped) and over the 2 micro-steps after a JAX-written
  ``MultiStepsState`` is restored: atol 1e-7, rtol 1e-6 (the bounds of
  ``tests/test_torch_postnet_train.py::test_rmsprop_matches_optax``); the
  counts exact. Two post-net task steps at ``accumulate_grad_batches: 2``:
  the parameters within atol 1e-6 of optax applied to the gradients the
  task's optimizers took (the bound of the post-net step tests), and
  unchanged after the first.
- Two SyncNet steps at ``bn`` (full width, K = 8 clips): each step's
  gradient within 1e-4 relative L2 of JAX's, the running statistics'
  included (the bound of ``tests/test_torch_syncnet.py``); the parameters
  and statistics within atol 1e-6, rtol 1e-5 of optax's Adam on the port's
  own gradients, and within 1e-5 relative L2 of the JAX task's own steps;
  the statistics move on both sides.
- The event files: the port's records, read back with TensorBoard's own
  loader, equal those of ``torch.utils.tensorboard.SummaryWriter`` (the JAX
  logger's writer) for the same calls: tags, steps, float32 values, image
  sizes and pixels.
- Two gloo ranks: the parameters after two steps bit-identical on both
  ranks and to one rank; with a different gradient on each rank before
  the task's all-reduce, still bit-identical on both ranks.
"""

import glob
import io
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geneface_tpu.models.syncnet import sync_loss as jsync_loss
from geneface_tpu.tasks import syncnet as jtask
from geneface_tpu.training.optim import finalize_optimizer
from geneface_tpu.training.schedules import build_schedule as jbuild_schedule
from geneface_tpu_torch.convert import (
    flax_param_tree,
    flax_variables,
    load_flax_variables,
    param_values_from_flax,
)
from geneface_tpu_torch.models.postnet.models import MLPDiscriminator
from geneface_tpu_torch.tasks import syncnet as task
from geneface_tpu_torch.tasks.postnet import PostnetAdvSyncTask
from geneface_tpu_torch.training.optim import RMSprop
from geneface_tpu_torch.training.schedules import build_schedule
from geneface_tpu_torch.utils.checkpoint import _CheckpointUnpickler, rms_state_from_optax
from geneface_tpu_torch.utils.logging import MetricsLogger
from tools.make_synthetic_lrs3 import make_lrs3, make_pose
from torch_audio_helpers import flat as _flat
from torch_audio_helpers import perturbed, rel_l2

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ddp_helpers as ddp  # noqa: E402

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)


# ------------------------------------------------------ RMSprop, MultiSteps --
def _grads(rng, params, i, bad=None):
    g = jax.tree_util.tree_map(
        lambda x: (rng.randn(*x.shape) * 10.0 ** rng.uniform(-6, 1, x.shape)).astype(np.float32),
        params)
    if i == bad:
        g["params"]["Dense_2"]["kernel"][3, 4] = np.nan
    return g


def _port_step(d, opt, grads):
    gt = param_values_from_flax(d, grads)
    for n, p in d.named_parameters():
        p.grad = torch.from_numpy(gt[n])
    opt.step()


def _assert_params(d, params, rtol=1e-6, atol=1e-7):
    got, want = _flat(flax_variables(d)), _flat(params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=str(k))


def _optax_state_in_the_port(state):
    """An optax state through the checkpoint's restricted unpickler, as a
    JAX run's checkpoint reaches the port."""
    pickled = pickle.dumps(jax.tree_util.tree_map(np.asarray, state))
    return rms_state_from_optax(_CheckpointUnpickler(io.BytesIO(pickled)).load())


def test_rmsprop_accumulation_matches_optax():
    cfg = dict(lr=5e-4, scheduler="none", accumulate_grad_batches=2)
    d = MLPDiscriminator(12)
    params = flax_variables(d)
    tx = finalize_optimizer(optax.rmsprop(lambda s: 5e-4 * 0.5), cfg)
    state = tx.init(params)
    schedule = build_schedule(cfg)
    opt = RMSprop(d, lambda s: schedule(s) * 0.5, accumulate_grad_batches=2)
    rng = np.random.RandomState(0)
    for i in range(5):
        grads = _grads(rng, params, i, bad=2)
        upd, state = tx.update(grads, state, params)
        params = jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, upd))
        _port_step(d, opt, grads)
        _assert_params(d, params)
    # micro-steps 0, 1 | 2 skipped | 3, 4: two RMSprop updates, none pending
    assert (int(opt.count), int(opt.skipped), int(opt.mini_step)) == (2, 1, 0)
    sd, ref = opt.state_dict(), _optax_state_in_the_port(state)
    for k in ("count", "skipped", "mini_step"):
        assert int(sd[k]) == int(ref[k]), k
    for k in ("nu", "acc_grads"):
        got = _flat(sd[k])
        for path, v in _flat(ref[k]).items():
            np.testing.assert_allclose(got[path], v, rtol=1e-6, atol=1e-12, err_msg=str(path))


def test_jax_accumulating_rmsprop_state_resumes_in_the_port():
    cfg = dict(lr=5e-4, scheduler="none", accumulate_grad_batches=2)
    d = MLPDiscriminator(12)
    params = flax_variables(d)
    tx = finalize_optimizer(optax.rmsprop(lambda s: 5e-4), cfg)
    state = tx.init(params)
    rng = np.random.RandomState(1)
    for i in range(3):  # one update applied, one micro-batch pending
        upd, state = tx.update(_grads(rng, params, i), state, params)
        params = jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, upd))
    load_flax_variables(d, params)
    opt = RMSprop(d, build_schedule(cfg), accumulate_grad_batches=2)
    opt.load_state_dict(_optax_state_in_the_port(state))
    assert (int(opt.count), int(opt.mini_step)) == (1, 1)
    for i in range(2):
        grads = _grads(rng, params, i)
        upd, state = tx.update(grads, state, params)
        params = jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, upd))
        _port_step(d, opt, grads)
        _assert_params(d, params)
    assert int(opt.count) == 2
    with pytest.raises(ValueError, match="accumulated"):
        RMSprop(d, build_schedule(cfg), accumulate_grad_batches=2).load_state_dict(
            {k: v for k, v in opt.state_dict().items() if k != "acc_grads"})


@pytest.fixture(scope="module")
def lrs3_dir(tmp_path_factory):
    return make_lrs3(str(tmp_path_factory.mktemp("lrs3")), n_train=6, n_val=2)


def test_postnet_task_accumulates_its_rmsprop_steps(lrs3_dir):
    """Two task steps at ``accumulate_grad_batches: 2``: the generator and
    the discriminator move only on the second, by optax's
    ``MultiSteps(rmsprop)`` of the two gradients each took; the
    checkpoint carries the pending state."""
    cfg = dict(lrs3_data_dir=lrs3_dir, person_data_dir=lrs3_dir, seed=3, lr=5e-4,
               scheduler="none", max_tokens=1000, syncnet_num_samples_per_batch=8,
               postnet_disc_lr_ratio=0.5, postnet_disc_start_steps=0, postnet_disc_interval=1,
               accumulate_grad_batches=2)
    t = PostnetAdvSyncTask(cfg, device="cpu")
    t.build()
    mods = {"gen_opt": t.model, "disc_opt": t.disc}
    start = {k: flax_variables(m) for k, m in mods.items()}
    grads = {k: [] for k in mods}
    for name, m in mods.items():
        opt = getattr(t, name)

        def recording(real=opt.step, name=name, m=m):
            grads[name].append(flax_param_tree(m, {n: p.grad for n, p in m.named_parameters()}))
            real()

        opt.step = recording
    batches = t.train_batches(0)
    t.train_step(next(batches))
    for name, m in mods.items():
        np.testing.assert_equal(_flat(flax_variables(m)), _flat(start[name]))
        assert int(getattr(t, name).mini_step) == 1
    payload = t.checkpoint_payload(1)
    t.train_step(next(batches))
    schedule = jbuild_schedule(cfg)
    for name, ratio in (("gen_opt", 1.0), ("disc_opt", 0.5)):
        tx = finalize_optimizer(optax.rmsprop(lambda s, r=ratio: schedule(s) * r), cfg)
        params = start[name]
        state = tx.init(params)
        for g in grads[name]:
            upd, state = tx.update(g, state, params)
            params = jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, upd))
        _assert_params(mods[name], params, rtol=0, atol=1e-6)
        assert (int(getattr(t, name).count), int(getattr(t, name).mini_step)) == (1, 0)
    fresh = PostnetAdvSyncTask(cfg, device="cpu")
    fresh.build()
    fresh.restore_state(payload["state"])
    for name in mods:
        sd, want = getattr(fresh, name).state_dict(), payload["state"][name]
        assert int(sd["mini_step"]) == 1 and int(sd["count"]) == 0
        np.testing.assert_equal(_flat(sd["acc_grads"]), _flat(want["acc_grads"]))


# ------------------------------------------------------------ SyncNet bn --
@jax.jit
def _jax_bn_grads(variables, mel, mouth, label):
    """The JAX task's loss and its gradient in the whole variables tree,
    ``batch_stats`` included (the tree the JAX task hands to Adam)."""
    from geneface_tpu.models.syncnet import LandmarkHubertSyncNet as JSyncNet

    def f(v):
        a, m = JSyncNet(lm_dim=60, norm="bn").apply(v, mel, mouth)
        return jsync_loss(a, m, label)[0]

    return jax.value_and_grad(f)(variables)


def test_syncnet_trains_its_bn_statistics_as_the_jax_task(lrs3_dir):
    cfg = dict(data_dir=lrs3_dir, seed=5, lr=1e-3, scheduler="none", max_tokens=1000,
               syncnet_num_samples_per_batch=8, syncnet_norm="bn",
               optimizer_adam_beta1=0.9, optimizer_adam_beta2=0.999)
    jt = jtask.SyncNetTask(cfg)
    state = jt.build()
    assert "batch_stats" in state["params"]
    state["params"] = perturbed(state["params"], seed=4)  # the statistics too: var 1 ± 0.1
    state["opt_state"] = jt.tx.init(state["params"])
    start = _flat(state["params"])
    t = task.SyncNetTask(cfg, device="cpu")
    t.build()
    load_flax_variables(t.model, state["params"])
    # the statistics are parameters of the port's optimizer
    names = dict(t.model.named_parameters())
    assert sum(n.endswith(("running_mean", "running_var")) for n in names) == 2 * 26
    tx = finalize_optimizer(optax.adam(cfg["lr"], b1=0.9, b2=0.999), cfg)
    shadow, shadow_state = state["params"], tx.init(state["params"])
    jupdate = jax.jit(jt.tx.update)
    update = jax.jit(tx.update)
    jb, tb = jt.train_batches(0), t.train_batches(0)
    for _ in range(2):
        b, b2 = next(jb), next(tb)
        clips = jt._mine(b)
        jloss, jg = _jax_bn_grads(state["params"], clips["mel"], clips["mouth"], clips["labels"])
        upd, opt_state = jupdate(jg, state["opt_state"], state["params"])
        state = {"params": optax.apply_updates(state["params"], upd), "opt_state": opt_state}
        metrics = t.train_step(b2)
        np.testing.assert_allclose(float(metrics["sync_loss"]), float(jloss), rtol=1e-5)
        g = flax_param_tree(t.model, {n: p.grad for n, p in t.model.named_parameters()})
        assert "batch_stats" in g
        jflat = _flat(jax.tree_util.tree_map(np.asarray, jg))
        gflat = _flat(g)
        assert sorted(gflat) == sorted(jflat)
        worst = max(rel_l2(v, jflat[k]) for k, v in gflat.items())
        assert worst <= 1e-4, worst
        assert all(np.abs(v).max() > 0 for k, v in gflat.items() if k[0] == "batch_stats")
        upd, shadow_state = update(g, shadow_state, shadow)
        shadow = jax.tree_util.tree_map(np.asarray, optax.apply_updates(shadow, upd))
    got = _flat(flax_variables(t.model))
    jfinal = _flat(jax.tree_util.tree_map(np.asarray, state["params"]))
    for k, want in _flat(shadow).items():
        np.testing.assert_allclose(got[k], want, rtol=1e-5, atol=1e-6, err_msg=str(k))
        assert rel_l2(got[k], jfinal[k]) <= 1e-5, (k, rel_l2(got[k], jfinal[k]))
    moved = [k for k in start if k[0] == "batch_stats"]
    assert moved and all(np.abs(got[k] - start[k]).max() > 0 for k in moved)
    assert all(np.abs(jfinal[k] - start[k]).max() > 0 for k in moved)
    # the checkpoint holds the trained statistics and Adam's in the JAX layout
    payload = t.checkpoint_payload(2)["state"]
    np.testing.assert_equal(_flat(payload["params"]["batch_stats"]),
                            {k[1:]: v for k, v in got.items() if k[0] == "batch_stats"})
    assert "batch_stats" in payload["opt_state"]["mu"]


# ------------------------------------------------------------ event files --
def test_event_files_read_back_as_tensorboards_own(tmp_path):
    from tensorboard.backend.event_processing.event_file_loader import RawEventFileLoader
    from tensorboard.compat.proto import event_pb2
    from torch.utils.tensorboard import SummaryWriter

    rng = np.random.RandomState(0)
    img = (rng.rand(5, 7, 3) * 255).astype(np.uint8)
    calls = [({"loss": 1.5, "psnr": np.float32(21.25), "skip": "text"}, 0, "tr/"),
             ({"loss": -3.0e-7}, 7, "val/")]
    logger = MetricsLogger(str(tmp_path / "port"))
    ref = SummaryWriter(str(tmp_path / "ref"))
    for scalars, step, prefix in calls:
        logger.log_scalars(scalars, step, prefix=prefix)
        for k, v in scalars.items():
            if not isinstance(v, str):
                ref.add_scalar(prefix + k, float(v), step)
    logger.log_image("val_render", img, 7)
    ref.add_image("val_render", img, 7, dataformats="HWC")
    logger.close()
    ref.close()

    def records(d):
        (path,) = glob.glob(os.path.join(d, "events.out.tfevents.*"))
        out = []
        for raw in RawEventFileLoader(path).Load():
            ev = event_pb2.Event.FromString(raw)
            assert ev.wall_time > 0
            for v in ev.summary.value:
                pix = None
                if v.HasField("image"):
                    from PIL import Image

                    pix = np.asarray(Image.open(io.BytesIO(v.image.encoded_image_string)))
                    v.image.ClearField("encoded_image_string")
                out.append((ev.step, str(v), None if pix is None else pix.tolist()))
            if not ev.HasField("summary"):
                out.append((ev.step, ev.file_version, ev.source_metadata.writer))
        return out

    got, want = records(str(tmp_path / "port" / "tb")), records(str(tmp_path / "ref"))
    assert got == want and len(got) == 5
    assert MetricsLogger(str(tmp_path / "off"), use_tensorboard=False)._tb is None
    assert not os.path.exists(tmp_path / "off" / "tb")


# -------------------------------------------------------- two gloo ranks --
@pytest.fixture(scope="module")
def pose_dir(tmp_path_factory):
    return make_pose(str(tmp_path_factory.mktemp("pose")), n_train=4, n_val=2, t_range=(40, 60))


def test_stage_a_ranks_stay_identical(lrs3_dir, pose_dir, tmp_path):
    """SyncNet (at ``bn``), the VAE and audio2pose on two gloo ranks: every
    rank runs the whole batch, as the JAX tasks do, and the tasks average
    the gradients before each step."""
    sync = dict(data_dir=lrs3_dir, seed=5, lr=1e-3, scheduler="none", max_tokens=1000,
                syncnet_num_samples_per_batch=8, syncnet_norm="bn")
    vae = dict(data_dir=lrs3_dir, seed=5, lr=1e-3, scheduler="none", max_tokens=1000,
               syncnet_num_samples_per_batch=8, lambda_sync=0.0)
    pose = dict(data_dir=pose_dir, seq_len=20, batch_size=2, recept_field=16, audio_in_dim=58,
                lr=1e-3, scheduler="none", seed=0)
    cases = {}
    for kind, cfg in (("syncnet", sync), ("vae", vae), ("audio2pose", pose)):
        t = ddp.make_task(kind, cfg)
        t.build()
        it = t.train_batches(0)
        batches = [next(it) for _ in range(2)]
        cases[kind] = dict(kind=kind, cfg=cfg, batches=batches)
        cases[kind + "_skew"] = dict(kind=kind, cfg=cfg, batches=batches, skew=1e-3)
    ranks = ddp.run_ranks("steps", {"cases": {k: dict(v) for k, v in cases.items()}}, 2,
                          str(tmp_path / "ranks"))
    for name, case in cases.items():
        a, b = (r[name]["params"] for r in ranks)
        assert a.keys() == b.keys() and len(a) > 0
        for n in a:
            np.testing.assert_array_equal(a[n], b[n], err_msg=f"{name} {n}")
        if "skew" not in name:
            one = ddp.step_result(**case)["params"]
            for n in a:
                np.testing.assert_array_equal(a[n], one[n], err_msg=f"{name} {n}")
        else:  # the skew reached the step: the ranks moved off the one-rank run
            plain = ranks[0][name[:-5]]["params"]
            assert any(not np.array_equal(a[n], plain[n]) for n in a), name
