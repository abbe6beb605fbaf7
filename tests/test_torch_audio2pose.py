"""The port's audio2pose WaveNet-GMM against the JAX package on the CPU: the
WaveNet and the model forward, the GMM loss and sampling, the rollout, two
training steps against optax, ``Audio2PoseInfer`` on a JAX-written
checkpoint, ``tasks/run.py`` training and ``--infer``, and the shipped
config's ``audio_in_dim`` quirk, which fails on both sides.

The WaveNet keeps its fixed widths (128/256 channels, 2 blocks of
dilations 1, 2, 4); the windows are short (T ≤ 33, R = 16). Tolerances:
float32 on both sides, the same parameters; forwards and the rollout's
poses within 1e-5 of max |ref|; the loss within 1e-5 relative and each
gradient within 1e-4 relative L2; the parameters after two Adam steps
within 1e-6 absolute of optax's on the port's own gradients (lr 1e-3; on
JAX's gradients one element in 32,768 moved 1.1e-5 apart: Adam's first
step maps a gradient near zero to ±lr whatever its last bits).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geneface_tpu.config import Config
from geneface_tpu.inference.audio2pose_infer import Audio2PoseInfer as JInfer
from geneface_tpu.models.audio2pose import Audio2PoseModel as JModel
from geneface_tpu.models.audio2pose import WaveNet as JWaveNet
from geneface_tpu.models.audio2pose import autoregressive_infer as j_rollout
from geneface_tpu.models.audio2pose import gmm_log_loss as j_loss
from geneface_tpu.models.audio2pose import sample_gmm as j_sample
from geneface_tpu.tasks.audio2pose import Audio2PoseTask as JTask
from geneface_tpu.tasks.audio2pose import _PoseSeqDataset as JPoseSeqDataset
from geneface_tpu.training.optim import finalize_optimizer
from geneface_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from geneface_tpu_torch.convert import flax_param_tree, flax_variables, load_flax_variables
from geneface_tpu_torch.inference.audio2pose_infer import Audio2PoseInfer
from geneface_tpu_torch.models.audio2pose import (
    Audio2PoseModel,
    WaveNet,
    autoregressive_infer,
    gmm_log_loss,
    sample_gmm,
)
from geneface_tpu_torch.tasks.audio2pose import Audio2PoseTask, pose_to_pose_velocity
from geneface_tpu_torch.tasks.run import main
from tools.make_synthetic_lrs3 import make_pose

torch.set_num_threads(1)

FWD = 1e-5
GRAD = 1e-4
R = 16


def close(got, ref, bound=FWD):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= bound, err


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def leaves(tree) -> dict:
    """``{"/".join(path): array}`` of a flax tree."""
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def perturbed(variables, seed=0, scale=0.05):
    """Every leaf moved off flax's init (the biases off zero)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + scale * rng.randn(*np.shape(x)).astype(np.float32),
        variables)


@pytest.fixture(scope="module")
def model_pair():
    """The JAX model (recept_field 16, 58 audio columns), its perturbed
    parameters and the port's model holding them."""
    jm = JModel(recept_field=R, audio_in_dim=58)
    params = perturbed(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, R, 58)),
                               jnp.zeros((1, R, 12))))
    tm = load_flax_variables(Audio2PoseModel(recept_field=R, audio_in_dim=58), params).eval()
    return jm, jax.jit(jm.apply), params, tm


@pytest.fixture(scope="module")
def pose_dir(tmp_path_factory):
    return make_pose(str(tmp_path_factory.mktemp("pose")), n_train=4, n_val=2, t_range=(40, 60))


def test_wavenet_matches_jax():
    jw = JWaveNet()
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 12).astype(np.float32)
    cond = rng.randn(2, 9, 256).astype(np.float32)
    params = perturbed(jw.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(cond)), 1)
    tw = load_flax_variables(WaveNet(), params)
    assert tw.receptive_field == jw.receptive_field == 15
    with torch.no_grad():
        for c in (cond, None):
            ref = jw.apply(params, jnp.asarray(x), None if c is None else jnp.asarray(c))
            got = tw(torch.from_numpy(x), None if c is None else torch.from_numpy(c))
            close(got, ref)
    # the map back gives the flax tree leaf for leaf
    back, ref = leaves(flax_variables(tw)), leaves(params)
    assert sorted(back) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k])


def test_model_and_loss_match_jax(model_pair):
    jm, japply, params, tm = model_pair
    rng = np.random.RandomState(2)
    audio = rng.randn(3, 20, 58).astype(np.float32)
    pv = rng.randn(3, 21, 12).astype(np.float32)
    ref = japply(params, jnp.asarray(audio), jnp.asarray(pv[:, :-1]))
    with torch.no_grad():
        out = tm(torch.from_numpy(audio), torch.from_numpy(pv[:, :-1]))
    assert out.shape == (3, 20, 25)
    close(out, ref)
    close(gmm_log_loss(out, torch.from_numpy(pv[:, 1:])), j_loss(ref, jnp.asarray(pv[:, 1:])))


def test_sample_gmm_matches_jax():
    """One center, ``sigma_scale`` 0: the mean, with the JAX path's NaN where
    ``exp(-x)`` overflows (``inf·0``)."""
    rng = np.random.RandomState(3)
    gmm = rng.randn(2, 5, 25).astype(np.float32)
    gmm[1, 3, 20] = -100.0  # exp(100) overflows float32
    ref = np.asarray(j_sample(jnp.asarray(gmm), 1, 12, jax.random.PRNGKey(0)))
    got = sample_gmm(torch.from_numpy(gmm), 1, 12, torch.Generator().manual_seed(0)).numpy()
    assert got.shape == ref.shape == (2, 5, 12)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got).sum() == 1
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(ref))
    np.testing.assert_array_equal(got[0], gmm[0, :, 1:13])
    # explicit choice and noise: mu + noise·exp(-x)·scale
    noise = torch.from_numpy(rng.randn(10, 12).astype(np.float32))
    sel = torch.zeros(10, dtype=torch.long)
    s = sample_gmm(torch.from_numpy(gmm[:1]).repeat(2, 1, 1), 1, 12, sigma_scale=0.5, sel=sel,
                   noise=noise)
    flat = gmm[:1].repeat(2, 0).reshape(10, 25)
    np.testing.assert_allclose(s.reshape(10, 12).numpy(),
                               flat[:, 1:13] + noise.numpy() * np.exp(-flat[:, 13:]) * 0.5,
                               rtol=1e-6)


def test_rollout_matches_jax(model_pair):
    jm, _, params, tm = model_pair
    audio = np.random.RandomState(4).randn(12, 58).astype(np.float32)
    init = np.random.RandomState(5).randn(6).astype(np.float32) * 0.1
    ref = np.asarray(j_rollout(jm, params, jnp.asarray(audio), jax.random.PRNGKey(0),
                               init_pose=init))
    got = autoregressive_infer(tm, torch.from_numpy(audio), init_pose=init,
                               generator=torch.Generator().manual_seed(0))
    assert got.shape == ref.shape == (12, 6)
    close(got, ref)


def test_two_train_steps_match_optax(pose_dir, model_pair):
    """The port's batches are the JAX dataset's bit for bit; two steps of
    the task from the same parameters: loss and gradients against
    ``jax.value_and_grad``, the parameters against optax's update of the
    same parameters by the port's gradient."""
    jm, _, params, _ = model_pair
    cfg = dict(data_dir=pose_dir, seq_len=20, batch_size=2, recept_field=R, audio_in_dim=58,
               lr=1e-3, scheduler="none", seed=0)
    task = Audio2PoseTask(cfg, device="cpu")
    task.build()
    load_flax_variables(task.model, params)
    jds = JPoseSeqDataset("train", pose_dir, 20, 58, np.random.RandomState(0))
    tx = finalize_optimizer(optax.adam(1e-3), Config(cfg))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)

    def loss_fn(p, b):
        out = jm.apply(p, b["audio"], b["pose_velocity"][:, :-1])
        return j_loss(out, b["pose_velocity"][:, 1:])

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    batches = task.train_batches(0)
    for _ in range(2):
        batch = next(batches)
        jb = jds.batch(2)
        for k in batch:
            np.testing.assert_array_equal(batch[k], jb[k])
        jl, jg = grad_fn(jp, {k: jnp.asarray(v) for k, v in jb.items()})
        task.optimizer.zero_grad(set_to_none=True)
        loss, _ = task.loss_fn(task.to_device(batch))
        loss.backward()
        assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
        # the last block's residual feeds nothing: no gradient here, zeros in JAX
        grads = leaves(flax_param_tree(task.model, {
            n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in task.model.named_parameters()}))
        ref = leaves(jg)
        assert sorted(grads) == sorted(ref)
        for k in ref:
            if "block_5']['res" in k:
                assert not ref[k].any() and not grads[k].any()
            else:
                assert rel_l2(grads[k], ref[k]) <= GRAD, k
        task.optimizer.step()
        # optax on the port's own gradient: Adam's first steps turn the
        # last-bit difference of a gradient near zero into a part of lr
        tree = flax_param_tree(task.model, {n: torch.zeros_like(p) if p.grad is None else p.grad
                                            for n, p in task.model.named_parameters()})
        upd, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, tree), opt_state, jp)
        jp = optax.apply_updates(jp, upd)
    ours, ref = leaves(flax_variables(task.model)), leaves(jp)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-6, rtol=0, err_msg=k)


def test_infer_reads_jax_checkpoint(model_pair, tmp_path):
    jm, _, params, _ = model_pair
    work = str(tmp_path / "a2p")
    j_save_checkpoint(os.path.join(work, "model_ckpt_steps_3.ckpt"),
                      {"state": {"params": params}, "step": 3})
    stats = str(tmp_path / "pose_data")
    os.makedirs(stats)
    np.savez(os.path.join(stats, "stats.npz"), mean_trans=np.array([0.1, -0.2, 3.0], np.float32),
             init_pose=np.linspace(-0.1, 0.1, 6).astype(np.float32))
    npy = str(tmp_path / "ds.npy")
    np.save(npy, np.random.RandomState(6).randn(12, 16, 29).astype(np.float32))
    cfg = dict(audio2pose_work_dir=work, recept_field=R, audio_in_dim=58, pose_data_dir=stats)
    ref = JInfer(Config(cfg)).infer(deepspeech_npy=npy)
    ours = Audio2PoseInfer(cfg, device="cpu")
    np.testing.assert_array_equal(ours.mean_trans, np.float32([0.1, -0.2, 3.0]))
    got = ours.infer(deepspeech_npy=npy, out_npy=str(tmp_path / "out" / "c2w.npy"))
    assert got.shape == ref.shape == (12, 4, 4)
    close(got, ref)
    np.testing.assert_array_equal(np.load(tmp_path / "out" / "c2w.npy"), got)
    np.testing.assert_array_equal(ours.get_cond_from_input(npy),
                                  np.load(npy)[:, 7:9].reshape(12, 58))
    # without stats.npz: zeros
    bare = Audio2PoseInfer(dict(cfg, pose_data_dir=str(tmp_path / "none")), device="cpu")
    assert not bare.mean_trans.any() and not bare.init_pose.any()


def test_run_trains_and_infers(pose_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    yaml = tmp_path / "a2p.yaml"
    yaml.write_text(
        f"base_config:\n  - {repo}/egs/datasets/videos/May/audio2pose.yaml\n"
        f"data_dir: {pose_dir}\nseq_len: 20\nbatch_size: 2\nrecept_field: {R}\n"
        "audio_in_dim: 58\nmax_updates: 2\nval_check_interval: 2\ntb_log_interval: 1\n"
        "num_sanity_val_steps: 1\neval_max_batches: 2\nwarmup_updates: 1\n")
    assert main(["--config", str(yaml), "--exp_name", "a2p", "--device", "cpu"]) == 2
    work = tmp_path / "checkpoints" / "a2p"
    assert (work / "model_ckpt_steps_2.ckpt").exists()
    npy = tmp_path / "ds.npy"
    np.save(npy, np.random.RandomState(7).randn(9, 16, 29).astype(np.float32))
    out = tmp_path / "pose.npy"
    assert main(["--config", str(yaml), "--exp_name", "a2p", "--infer", "--device", "cpu",
                 "--hparams", f"audio2pose_work_dir={work},infer_audio_source_name={npy},"
                 f"infer_out_npy_name={out}"]) == 0
    c2w = np.load(out)
    assert c2w.shape == (9, 4, 4) and np.isfinite(c2w).all()
    np.testing.assert_array_equal(c2w[:, 3], np.tile([0, 0, 0, 1], (9, 1)))


def test_shipped_audio_in_dim_fails_on_both_sides(pose_dir, tmp_path):
    """``egs/egs_bases/audio2pose/base.yaml`` sets ``audio_in_dim: 29``,
    while the store and ``get_cond_from_input`` give 58 columns: the JAX
    task's first step fails, and so does the port's; and a 29-wide
    checkpoint cannot infer from a DeepSpeech ``.npy`` on either side."""
    cfg = dict(data_dir=pose_dir, seq_len=20, batch_size=2, recept_field=R, audio_in_dim=29,
               lr=1e-3, scheduler="none", seed=0, work_dir=str(tmp_path / "j"))
    jtask = JTask(Config(cfg))
    state = jtask.build()
    batch = next(jtask.train_batches(0))
    assert batch["audio"].shape[-1] == 58
    with pytest.raises(Exception, match="29"):
        jtask.train_step(state, batch, jax.random.PRNGKey(0))
    task = Audio2PoseTask(cfg, device="cpu")
    task.build()
    with pytest.raises(RuntimeError, match="29"):
        task.train_step(next(task.train_batches(0)))

    work = str(tmp_path / "a2p29")
    j_save_checkpoint(os.path.join(work, "model_ckpt_steps_0.ckpt"),
                      {"state": {"params": flax_variables(task.model)}, "step": 0})
    npy = str(tmp_path / "ds.npy")
    np.save(npy, np.zeros((4, 16, 29), np.float32))
    icfg = dict(audio2pose_work_dir=work, recept_field=R, audio_in_dim=29)
    with pytest.raises(Exception, match="29"):
        JInfer(Config(icfg)).infer(deepspeech_npy=npy)
    with pytest.raises(RuntimeError, match="29"):
        Audio2PoseInfer(icfg, device="cpu").infer(deepspeech_npy=npy)


def test_pose_velocity():
    pose = np.random.RandomState(8).randn(5, 6).astype(np.float32)
    pv = pose_to_pose_velocity(pose)
    assert pv.shape == (5, 12) and not pv[0, 6:].any()
    np.testing.assert_array_equal(pv[1:, 6:], pose[1:] - pose[:-1])
