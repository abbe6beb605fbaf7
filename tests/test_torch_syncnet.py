"""The port's SyncNet, its clip mining and gathering, and its training task
against the JAX package on the CPU.

- The towers at full width (HuBERT 1024 → 512 in 13 blocks, mouth 60 →
  512 in 13 blocks), ``ln`` and ``bn``, at K = 8 clips, every leaf
  perturbed from the flax init: embeddings within 1e-5 of max |ref| (float32
  convolutions summing up to 3 × 1024 terms in another order), ``sync_loss``
  and every parameter's and input's gradient within 1e-4 relative L2.
- ``mine_sync_clips`` bit-identical (the same ``RandomState`` draws) over 3
  seeds, ``infer`` on and off, with a batch of one.
- ``gather_clips`` (the row gather over the flattened batch) exact, and its
  gradient (K1's scatter-add on the CPU) exact to JAX's.
- Two ``SyncNetTask`` steps from the same parameters on the same store:
  the same batches and clips, each step's gradient within 1e-4 relative L2
  of JAX's, the parameters within atol 1e-6, rtol 1e-5 of optax's Adam on
  those gradients (see the test for why not of JAX's own steps, which are
  held to 1e-5 relative L2); ``build_adam`` alone within atol 1e-7 of
  optax on the same gradients, a non-finite step skipped.
- ``syncnet_params_from_torch`` equal to the JAX importer on a
  GeneFace-layout state_dict authored from seeded numpy.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneface_tpu.models.syncnet import LandmarkHubertSyncNet as JSyncNet
from geneface_tpu.models.syncnet import sync_loss as jsync_loss
from geneface_tpu.tasks import syncnet as jtask
from geneface_tpu.utils import torch_import as jti
from geneface_tpu_torch.convert import flax_variables, load_flax_variables
from geneface_tpu_torch.models.syncnet.models import LandmarkHubertSyncNet, sync_loss
from geneface_tpu_torch.tasks import syncnet as task
from geneface_tpu_torch.utils import torch_import as ti
from tools.make_synthetic_lrs3 import make_lrs3
from torch_audio_helpers import flat as _flat
from torch_audio_helpers import perturbed, rel_l2

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)


#: clips per SyncNet call in these tests (the towers' check and the task's
#: steps share one jitted JAX gradient per norm)
K = 8
JAX_NETS = {norm: JSyncNet(norm=norm) for norm in ("ln", "bn")}


@partial(jax.jit, static_argnums=0)
def jax_loss_and_grads(norm, variables, mel, mouth, label):
    """JAX's sync loss, embeddings and gradients (parameters, both inputs)."""
    def f(p, mel, mouth):
        a, m = JAX_NETS[norm].apply({**variables, "params": p}, mel, mouth)
        return jsync_loss(a, m, label)[0], (a, m)
    return jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(variables["params"], mel, mouth)


@pytest.fixture(scope="module", params=["ln", "bn"])
def towers(request):
    """JAX and port SyncNet on the same perturbed variables."""
    norm = request.param
    rng = np.random.RandomState(1)
    mel = rng.randn(K, 10, 1024).astype(np.float32)
    mouth = rng.randn(K, 5, 60).astype(np.float32)
    label = np.array([1, 0] * (K // 2), np.float32)
    v = perturbed(JAX_NETS[norm].init(jax.random.PRNGKey(0), mel, mouth), seed=2)
    (loss, (a, m)), grads = jax_loss_and_grads(norm, v, mel, mouth, label)
    model = load_flax_variables(LandmarkHubertSyncNet(norm=norm), v)
    return dict(model=model, v=v, mel=mel, mouth=mouth, label=label, loss=float(loss),
                a=np.asarray(a), m=np.asarray(m), grads=jax.tree_util.tree_map(np.asarray, grads))


def test_towers_match_jax(towers):
    model = towers["model"]
    mel = torch.from_numpy(towers["mel"]).requires_grad_(True)
    mouth = torch.from_numpy(towers["mouth"]).requires_grad_(True)
    a, m = model(mel, mouth)
    for got, ref in ((a, towers["a"]), (m, towers["m"])):
        got = got.detach().numpy()
        assert got.shape == (K, 512)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    loss, d = sync_loss(a, m, torch.from_numpy(towers["label"]))
    assert abs(float(loss) - towers["loss"]) <= 1e-4 * abs(towers["loss"])
    assert float(d.min()) >= 1e-7 and float(d.max()) <= 1 - 1e-7
    model.zero_grad()
    loss.backward()
    gp, gmel, gmouth = towers["grads"]
    ours = flax_variables(model)  # the layout only; the gradients are mapped below
    from geneface_tpu_torch.convert import flax_param_tree

    gtree = flax_param_tree(model, {n: p.grad for n, p in model.named_parameters()})["params"]
    want = _flat(gp)
    got = _flat(gtree)
    assert sorted(got) == sorted(want) and sorted(want) == sorted(_flat(ours["params"]))
    worst = max(rel_l2(got[k], want[k]) for k in want)
    assert worst <= 1e-4, worst
    assert rel_l2(mel.grad.numpy(), gmel) <= 1e-4
    assert rel_l2(mouth.grad.numpy(), gmouth) <= 1e-4


def test_sync_loss_clips_the_cosine():
    a = torch.tensor([[1.0, 0.0], [1.0, 0.0]])
    m = torch.tensor([[1.0, 0.0], [0.0, 1.0]])  # cosine 1 and 0
    loss, d = sync_loss(a, m, torch.tensor([1.0, 0.0]))
    jloss, jd = jsync_loss(jnp.asarray(a.numpy()), jnp.asarray(m.numpy()), np.array([1.0, 0.0]))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("infer", [False, True])
def test_mining_is_bit_identical(seed, infer):
    y_lens = np.array([40, 7, 5, 33, 64, 12])
    for lens, k in ((y_lens, 50), (y_lens[:1], 9)):
        got = task.mine_sync_clips(lens, k, np.random.RandomState(seed), infer=infer)
        want = jtask.mine_sync_clips(lens, k, np.random.RandomState(seed), infer=infer)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        if infer:
            assert (got[4] == 1).all()


def test_gather_clips_and_gradient_exact():
    rng = np.random.RandomState(3)
    B, T = 3, 32
    mouth = rng.randn(B, T, 60).astype(np.float32)
    hubert = rng.randn(B, 2 * T, 16).astype(np.float32)
    ii, ms, mi, mel_s, _ = jtask.mine_sync_clips(np.array([32, 20, 11]), 24,
                                                 np.random.RandomState(0))
    jm, jh = jtask.gather_clips(jnp.asarray(mouth), jnp.asarray(hubert), *map(jnp.asarray,
                                                                           (ii, ms, mi, mel_s)))
    tm = torch.from_numpy(mouth).requires_grad_(True)
    m, h = task.gather_clips(tm, torch.from_numpy(hubert), ii, ms, mi, mel_s)
    np.testing.assert_array_equal(m.detach().numpy(), np.asarray(jm))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    w = rng.randn(*m.shape).astype(np.float32)
    (m * torch.from_numpy(w)).sum().backward()
    jg = jax.grad(lambda x: jnp.sum(jtask.gather_clips(
        x, jnp.asarray(hubert), *map(jnp.asarray, (ii, ms, mi, mel_s)))[0] * w))(
        jnp.asarray(mouth))
    np.testing.assert_array_equal(tm.grad.numpy(), np.asarray(jg))
    with pytest.raises(IndexError):
        task.clip_rows(np.array([0]), np.array([28]), T, 5)


@pytest.fixture(scope="module")
def lrs3_dir(tmp_path_factory):
    return make_lrs3(str(tmp_path_factory.mktemp("lrs3")), n_train=6, n_val=2)


def _cfg(data_dir):
    return dict(data_dir=data_dir, seed=5, lr=1e-3, scheduler="none", max_tokens=1000,
                syncnet_num_samples_per_batch=K, optimizer_adam_beta1=0.9,
                optimizer_adam_beta2=0.999)


def test_two_task_steps_match_optax(lrs3_dir):
    """Two steps of each package's task from the same parameters, on the
    same batches and clips. Adam's first steps move an element by about
    ``lr·g/(|g| + 1e-8)``, and ~20% of the full-width towers' gradient
    elements lie under 1e-7 (the deep 512-channel blocks), where a
    last-bits difference of the gradient (the frameworks sum the
    convolutions' products in other orders) moves the update by up to a
    tenth of ``lr``. So the step is held in its two parts: each step's
    gradient against JAX's on the same parameters and clips (1e-4
    relative L2 per leaf), and the parameters against optax's Adam applied
    to the port's own gradients (atol 1e-6, rtol 1e-5); the parameters
    after JAX's own two steps to 1e-5 relative L2 per leaf."""
    import optax

    from geneface_tpu.training.optim import finalize_optimizer
    from geneface_tpu_torch.convert import flax_param_tree

    cfg = _cfg(lrs3_dir)
    jt = jtask.SyncNetTask(cfg)
    state = jt.build()
    state["params"] = perturbed(state["params"], seed=4)
    state["opt_state"] = jt.tx.init(state["params"])
    t = task.SyncNetTask(cfg, device="cpu")
    t.build()
    load_flax_variables(t.model, state["params"])
    tx = finalize_optimizer(optax.adam(cfg["lr"], b1=0.9, b2=0.999), cfg)
    shadow = state["params"]
    shadow_state = tx.init(shadow)

    jupdate = jax.jit(jt.tx.update)  # the JAX task's step: its gradient, its optimizer
    update = jax.jit(tx.update)
    jb, tb = jt.train_batches(0), t.train_batches(0)
    for _ in range(2):
        b, b2 = next(jb), next(tb)
        for k in ("hubert", "y", "y_mask", "mouth_lm3d"):
            np.testing.assert_array_equal(b[k], b2[k])
        clips = jt._mine(b)
        (jloss, _), (jgt, _, _) = jax_loss_and_grads("ln", state["params"], clips["mel"],
                                                     clips["mouth"], clips["labels"])
        jgt = {"params": jgt}
        jg = _flat(jax.tree_util.tree_map(np.asarray, jgt))
        upd, opt_state = jupdate(jgt, state["opt_state"], state["params"])
        state = {"params": optax.apply_updates(state["params"], upd), "opt_state": opt_state}
        metrics = t.train_step(b2)
        np.testing.assert_allclose(float(metrics["sync_loss"]), float(jloss), rtol=1e-5)
        g = flax_param_tree(t.model, {n: p.grad for n, p in t.model.named_parameters()})
        worst = max(rel_l2(v, jg[k]) for k, v in _flat(g).items())
        assert worst <= 1e-4, worst
        upd, shadow_state = update(g, shadow_state, shadow)
        shadow = jax.tree_util.tree_map(np.asarray, optax.apply_updates(shadow, upd))
    got = _flat(flax_variables(t.model))
    for ref, check in ((_flat(shadow), "optax"), (_flat(jax.tree_util.tree_map(
            np.asarray, state["params"])), "jax")):
        assert sorted(got) == sorted(ref)
        for k in ref:
            if check == "optax":
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-6, err_msg=str(k))
            else:
                assert rel_l2(got[k], ref[k]) <= 1e-5, (k, rel_l2(got[k], ref[k]))
    assert int(t.optimizer.count) == 2


def test_adam_matches_optax_on_the_same_gradients():
    """``build_adam`` (one group, eps 1e-8, no clipping although
    ``clip_grad_norm`` is set) against ``finalize_optimizer(optax.adam)``
    over 3 steps of the same gradients, one of them non-finite (skipped)."""
    import optax

    from geneface_tpu.training.optim import finalize_optimizer
    from geneface_tpu_torch.training.optim import build_adam
    from geneface_tpu_torch.training.schedules import build_schedule

    cfg = dict(lr=1e-3, scheduler="none", clip_grad_norm=1.0, optimizer_adam_beta1=0.9,
               optimizer_adam_beta2=0.999)
    model = LandmarkHubertSyncNet()
    params = flax_variables(model)
    tx = finalize_optimizer(optax.adam(1e-3, b1=0.9, b2=0.999), cfg)
    opt_state = tx.init(params)
    opt = build_adam(model, build_schedule(cfg), cfg)
    rng = np.random.RandomState(0)
    from geneface_tpu_torch.convert import param_values_from_flax

    update = jax.jit(tx.update)
    for i in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: (rng.randn(*x.shape) * 10.0 ** rng.uniform(-9, 1, x.shape)).astype(
                np.float32), params)
        if i == 1:
            grads["params"]["ConvBlock_3"]["Conv_0"]["bias"][0] = np.nan
        upd, opt_state = update(grads, opt_state, params)
        params = jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, upd))
        gt = param_values_from_flax(model, grads)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(gt[n])
        opt.step()
    want, got = _flat(params), _flat(flax_variables(model))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=str(k))
    assert int(opt.count) == 2 and int(opt.skipped) == 1


def test_syncnet_importer_matches_jax():
    jtemplate = JSyncNet(norm="bn").init(jax.random.PRNGKey(0), np.zeros((1, 10, 1024), np.float32),
                                         np.zeros((1, 5, 60), np.float32))
    v = perturbed(jtemplate, seed=6)
    sd = {}
    for tower, first in (("hubert_encoder", 0), ("mouth_encoder", 13)):
        for i in range(13):
            p = v["params"][f"ConvBlock_{first + i}"]
            s = v["batch_stats"][f"ConvBlock_{first + i}"]["BatchNorm_0"]
            key = f"{tower}.{i}.conv_block"
            sd[f"{key}.0.weight"] = p["Conv_0"]["kernel"].transpose(2, 1, 0)
            sd[f"{key}.0.bias"] = p["Conv_0"]["bias"]
            sd[f"{key}.1.weight"] = p["BatchNorm_0"]["scale"]
            sd[f"{key}.1.bias"] = p["BatchNorm_0"]["bias"]
            sd[f"{key}.1.running_mean"] = s["mean"]
            sd[f"{key}.1.running_var"] = s["var"]
    want = _flat(jax.tree_util.tree_map(np.asarray, jti.syncnet_params_from_torch(sd, jtemplate)))
    got = _flat(ti.syncnet_params_from_torch(sd, flax_variables(LandmarkHubertSyncNet(norm="bn"))))
    assert sorted(got) == sorted(want) and len(want) == 26 * 6
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got[("params", "ConvBlock_20", "Conv_0", "kernel")],
                                  v["params"]["ConvBlock_20"]["Conv_0"]["kernel"])
    with pytest.raises(ValueError, match="norm='bn'"):
        ti.syncnet_params_from_torch(sd, flax_variables(LandmarkHubertSyncNet(norm="ln")))
