"""The post-net's adversarial training against the JAX package on the CPU.

- ``MLPDiscriminator`` (204 → 128 → 256 → 256 → 128 → 1, leaky ReLU,
  the bias-free head) and its frame mask: 1e-5 of max |ref|.
- One generator step and one discriminator step of the plain and the pitch
  task (``reg`` and ``continuity`` on), with ``adv_on`` 0 and 1, against
  the JAX task's jitted ``gen_step``/``disc_step`` on the same batches,
  clips, frozen VAE and SyncNet, and the same prior noise (JAX draws it
  from ``split(rng)``): losses within rtol 1e-4, each gradient within 1e-4
  relative L2 of JAX's (the JAX steps run with an optimizer that hands
  the gradient back; ~3e-7 here) without the sync term, and within 2e-2
  with it (``adv_on`` 1): the frozen SyncNet's 26 ReLU layers hold ~1e6
  pre-activations per step, and one within float32 rounding of zero turns
  the other way on one side; on the pitch task's draw the port's float32
  gradient then lay 1.3e-2 from its own float64 one, which JAX's matched
  to 1.4e-6, while on another draw the two port runs agreed to 1e-6. The
  parameters after the port's
  RMSprop step within atol 1e-6 of optax's RMSprop applied to the port's
  gradient and to JAX's. RMSprop's first step moves an element by
  ``lr·g/sqrt(0.1·g² + 1e-8)``, which turns a gradient's last bits into up
  to ``lr·1e4·δg`` where ``|g|`` is near 1e-4: elements whose gradient is
  under 1e-3 are held against JAX's gradient to the step's own size
  (``2·sqrt(10)·lr``), the rest to atol 1e-6; with the sync term all of
  them are (a flipped SyncNet ReLU moves single gradient elements by
  their whole size), while the step on the port's own gradient stays
  held to atol 1e-6.
- ``RMSprop`` against ``finalize_optimizer(optax.rmsprop)`` over 3 steps of
  the same gradients, one of them non-finite (skipped), and the
  discriminator's rate ``schedule · postnet_disc_lr_ratio``.
- ``postnet_disc_interval: 2`` steps the discriminator on every other
  step; the task step is carried by ``on_save``/``on_restore``.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geneface_tpu.models.postnet import MLPDiscriminator as JDisc
from geneface_tpu.tasks import postnet as jtask
from geneface_tpu.tasks.syncnet import mine_sync_clips
from geneface_tpu_torch.convert import flax_param_tree, flax_variables, load_flax_variables
from geneface_tpu_torch.models.postnet.models import MLPDiscriminator
from geneface_tpu_torch.tasks.postnet import PostnetAdvSyncTask
from geneface_tpu_torch.tasks.syncnet import to_device
from tools.make_synthetic_lrs3 import make_lrs3
from torch_audio_helpers import flat as _flat
from torch_audio_helpers import perturbed, rel_l2

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)

PITCH_CLS = "geneface_tpu.tasks.audio2motion.PitchContourVAESyncTask"


def test_discriminator_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 204).astype(np.float32)
    x[1, 11:] = 0.0
    jd = JDisc(204)
    v = perturbed(jd.init(jax.random.PRNGKey(0), x), seed=1)
    jv, jmask = jd.apply(v, x)
    d = load_flax_variables(MLPDiscriminator(204), v)
    assert d.Dense_4.bias is None
    with torch.no_grad():
        tv, tmask = d(torch.from_numpy(x))
    ref = np.asarray(jv)
    np.testing.assert_allclose(tv.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert not tmask[1, 11:].any()
    back = _flat(flax_variables(d))
    for k, w in _flat(v).items():
        np.testing.assert_array_equal(back[k], w)


@pytest.fixture(scope="module")
def lrs3_dir(tmp_path_factory):
    return make_lrs3(str(tmp_path_factory.mktemp("lrs3")), n_train=6, n_val=2)


def _cfg(data_dir, pitch, **over):
    cfg = dict(lrs3_data_dir=data_dir, person_data_dir=data_dir, seed=3, lr=5e-4,
               scheduler="none", max_tokens=1000, syncnet_num_samples_per_batch=8,
               postnet_lambda_mse=0.05, postnet_lambda_adv=0.85, postnet_lambda_sync=0.1,
               postnet_lambda_reg=0.02, postnet_lambda_continuity=0.1,
               postnet_disc_lr_ratio=0.5, postnet_disc_start_steps=0, postnet_disc_interval=1)
    if pitch:
        cfg["audio2motion_task_cls"] = PITCH_CLS
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "pitch"])
def pair(request, lrs3_dir):
    return make_pair(lrs3_dir, pitch=request.param)


def make_pair(lrs3_dir, pitch: bool) -> tuple:
    """The JAX and the port task on the same perturbed generator and
    discriminator, frozen VAE and SyncNet. The JAX task gets its modules
    and frozen parameters set as its ``build`` sets them (its own ``build``
    spends ~30 s in eager flax inits), from the port's seeded ones."""
    from geneface_tpu.models.audio2motion import PitchContourVAEModel as JPitchVAE
    from geneface_tpu.models.audio2motion import VAEModel as JVAE
    from geneface_tpu.models.postnet import CNNPostNet as JPostNet
    from geneface_tpu.models.postnet import PitchContourCNNPostNet as JPitchPostNet
    from geneface_tpu.models.syncnet import LandmarkHubertSyncNet as JSyncNet
    from geneface_tpu.training.optim import finalize_optimizer
    from geneface_tpu.training.schedules import build_schedule

    cfg = _cfg(lrs3_dir, pitch)
    t = PostnetAdvSyncTask(cfg, device="cpu")
    t.build()
    assert t.pitch == pitch
    jt = jtask.PostnetAdvSyncTask(cfg)
    jt.pitch = pitch
    jt.model = JPitchPostNet(in_out_dim=204, pitch_dim=64) if pitch else JPostNet(in_out_dim=204)
    jt.disc = JDisc(in_dim=204)
    jt.vae = (JPitchVAE if pitch else JVAE)(in_out_dim=204)
    jt.syncnet = JSyncNet(lm_dim=60)
    jt.train_ds = t.train_ds
    load_flax_variables(t.vae, perturbed(flax_variables(t.vae), seed=3, scale=0.02))
    jt.vae_params = jax.tree_util.tree_map(jnp.asarray, flax_variables(t.vae))
    jt.sync_params = jax.tree_util.tree_map(jnp.asarray, flax_variables(t.syncnet))
    state = {"gen_params": perturbed(flax_variables(t.model), seed=1),
             "disc_params": perturbed(flax_variables(t.disc), seed=2, scale=0.05)}
    schedule = build_schedule(cfg)
    txs = (finalize_optimizer(optax.rmsprop(schedule), cfg), finalize_optimizer(
        optax.rmsprop(lambda s: schedule(s) * cfg["postnet_disc_lr_ratio"]), cfg))
    # the jitted steps run with an optimizer that hands the gradient back
    jt.gen_tx = jt.disc_tx = optax.GradientTransformation(
        lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)},
        lambda u, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, u), {"g": u}))
    jt._build_jits()
    return jt, t, state, txs


def _grad_tree(model):
    return flax_param_tree(model, {n: p.grad for n, p in model.named_parameters()})


def assert_step_matches(model, p0, port_g, jax_g, tx, lr, flips: bool = False):
    """The port's parameters after its step against ``tx`` (optax's
    RMSprop) applied to its own gradient (atol 1e-6) and to JAX's (atol
    1e-6 where ``|g| >= 1e-3``, the step's size elsewhere, and everywhere
    when ``flips``: a ReLU of the frozen SyncNet may turn the other way)."""
    got = _flat(flax_variables(model))
    for g, loose in ((port_g, False), (jax_g, True)):
        upd, _ = tx.update(g, tx.init(p0), p0)
        want = _flat(jax.tree_util.tree_map(np.asarray, optax.apply_updates(p0, upd)))
        grads = _flat(g)
        for k in want:
            diff = np.abs(got[k] - want[k])
            sensitive = (np.abs(grads[k]) < 1e-3) | flips if loose else np.zeros_like(diff, bool)
            assert (diff[~sensitive] <= 1e-6).all(), (k, loose, diff[~sensitive].max())
            assert (diff <= 2 * np.sqrt(10) * lr).all(), k


@pytest.mark.parametrize("adv_on", [0.0, 1.0])
def test_one_generator_and_discriminator_step_match_jax(pair, adv_on):
    jt, t, state, (gen_tx, disc_tx) = pair
    lr = t.cfg["lr"]
    gen0 = jax.tree_util.tree_map(np.asarray, state["gen_params"])
    disc0 = jax.tree_util.tree_map(np.asarray, state["disc_params"])
    load_flax_variables(t.model, gen0)
    load_flax_variables(t.disc, disc0)
    t.gen_opt.load_state_dict({"count": np.int32(0), "skipped": np.int32(0),
                               "nu": jax.tree_util.tree_map(np.zeros_like, gen0)})
    t.disc_opt.load_state_dict({"count": np.int32(0), "skipped": np.int32(0),
                                "nu": jax.tree_util.tree_map(np.zeros_like, disc0)})
    batches = jt.train_ds.iter_batches(seed=0)
    lrs3, person = next(batches), next(batches)
    keys = ("hubert", "y", "y_mask") + (("f0",) if jt.pitch else ())
    jl = {k: jnp.asarray(lrs3[k]) for k in keys}
    jp = {k: jnp.asarray(person[k]) for k in keys}
    idx = mine_sync_clips(lrs3["y_mask"].sum(-1).astype(int), 8, np.random.RandomState(0),
                          infer=True)[:4]
    rng = jax.random.PRNGKey(11)
    _, jgen, jlosses, jpred = jt._gen_step_fn(
        jax.tree_util.tree_map(jnp.asarray, gen0), state["disc_params"],
        jt.gen_tx.init(gen0), jl, jp, tuple(map(jnp.asarray, idx)), rng, jnp.float32(adv_on))
    k1, k2 = jax.random.split(rng)
    tl, tp = to_device(lrs3, keys, "cpu"), to_device(person, keys, "cpu")
    noises = tuple(torch.from_numpy(np.asarray(jax.random.normal(k, t.vae.noise_shape(
        *d["y_mask"].shape)))) for k, d in ((k1, tl), (k2, tp)))
    t.gen_opt.zero_grad()
    total, losses, pred = t.gen_loss(tl, tp, idx, noises, adv_on)
    total.backward()
    t.gen_opt.step()
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-4, err_msg=k)
    assert float(losses["reg"]) > 0 and float(losses["continuity"]) > 0
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jpred)).max())
    g, jg = _grad_tree(t.model), jax.tree_util.tree_map(np.asarray, jgen["g"])
    flat_jg = _flat(jg)
    worst = max((rel_l2(a, flat_jg[k]), k) for k, a in _flat(g).items())
    assert worst[0] <= (1e-4 if adv_on == 0.0 else 2e-2), worst
    assert_step_matches(t.model, gen0, g, jg, gen_tx, lr, flips=adv_on == 1.0)
    # the discriminator on the same refinement (JAX's)
    _, jdisc, jdl = jt._disc_step_fn(jax.tree_util.tree_map(jnp.asarray, disc0),
                                     jt.disc_tx.init(disc0), jpred, jp["y"], jp["y_mask"])
    t.disc_opt.zero_grad()
    d_total, dl = t.disc_loss(torch.from_numpy(np.asarray(jpred)), tp["y"], tp["y_mask"])
    d_total.backward()
    t.disc_opt.step()
    for k, v in jdl.items():
        np.testing.assert_allclose(float(dl[k]), float(v), rtol=1e-4, err_msg=k)
    g, jg = _grad_tree(t.disc), jax.tree_util.tree_map(np.asarray, jdisc["g"])
    flat_jg = _flat(jg)
    worst = max((rel_l2(a, flat_jg[k]), k) for k, a in _flat(g).items())
    assert worst[0] <= 1e-4, worst
    assert_step_matches(t.disc, disc0, g, jg, disc_tx, lr * t.cfg["postnet_disc_lr_ratio"])


def test_rmsprop_matches_optax():
    import optax

    from geneface_tpu.training.optim import finalize_optimizer
    from geneface_tpu_torch.convert import param_values_from_flax
    from geneface_tpu_torch.training.optim import RMSprop
    from geneface_tpu_torch.training.schedules import build_schedule

    cfg = dict(lr=5e-4, scheduler="none")
    d = MLPDiscriminator(12)
    params = flax_variables(d)
    ratio = 0.5
    tx = finalize_optimizer(optax.rmsprop(lambda s: 5e-4 * ratio), cfg)
    state = tx.init(params)
    schedule = build_schedule(cfg)
    opt = RMSprop(d, lambda s: schedule(s) * ratio)
    rng = np.random.RandomState(0)
    for i in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: (rng.randn(*x.shape) * 10.0 ** rng.uniform(-6, 1, x.shape)).astype(
                np.float32), params)
        if i == 1:
            grads["params"]["Dense_2"]["kernel"][3, 4] = np.inf
        upd, state = tx.update(grads, state, params)
        params = jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, upd))
        gt = param_values_from_flax(d, grads)
        for n, p in d.named_parameters():
            p.grad = torch.from_numpy(gt[n])
        opt.step()
    got, want = _flat(flax_variables(d)), _flat(params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=str(k))
    assert int(opt.count) == 2 and int(opt.skipped) == 1
    # the state carries optax's nu, read back through a fresh optimizer
    import pickle

    from geneface_tpu_torch.utils.checkpoint import _CheckpointUnpickler, rms_state_from_optax

    sd = opt.state_dict()
    pickled = pickle.dumps(jax.tree_util.tree_map(np.asarray, state))
    ref = rms_state_from_optax(_CheckpointUnpickler(io.BytesIO(pickled)).load())
    assert int(sd["count"]) == int(ref["count"]) == 2 and int(ref["skipped"]) == 1
    got = _flat(sd["nu"])
    for k, v in _flat(ref["nu"]).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-12)


def test_disc_interval_two_steps_every_other_step(lrs3_dir):
    t = PostnetAdvSyncTask(_cfg(lrs3_dir, False, postnet_disc_interval=2,
                                postnet_disc_start_steps=1), device="cpu")
    t.build()
    batches = t.train_batches(0)
    seen = []
    for step in range(3):
        before = {n: p.detach().clone() for n, p in t.disc.named_parameters()}
        losses = t.train_step(next(batches))
        moved = any(not torch.equal(p, before[n]) for n, p in t.disc.named_parameters())
        seen.append((moved, "disc_fake_loss" in losses))
        assert all(np.isfinite(float(v)) for v in losses.values())
    assert seen == [(True, True), (False, False), (True, True)]
    assert int(t.disc_opt.count) == 2 and int(t.gen_opt.count) == 3
    assert t.on_save() == {"task_step": 3}
    t.on_restore({"task_step": 7})
    assert t._step == 7 and t.adv_on() == 1.0
