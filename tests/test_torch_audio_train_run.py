"""Stage A's training chain through the port's entry point, on the CPU.

- ``python -m geneface_tpu_torch.tasks.run`` (``main``) on the shipped
  configs, 2 steps each: SyncNet (``lm3d_syncnet.yaml``), then the VAE
  (``lm3d_vae_sync.yaml``) on that SyncNet run, then the post-net
  (``lm3d_postnet_sync.yaml``) on both; every loss finite, the frozen
  upstreams bit-identical afterwards, and the checkpoints in the JAX
  trainer's layout.
- The JAX post-net task builds on the port's SyncNet and VAE runs and
  holds their parameters exactly (the JAX VAE task reads
  ``syncnet_work_dir`` with the same lines; its own build spends ~14 s in
  an eager flax init).
- A post-net checkpoint written by the JAX package (its checkpoint writer,
  the JAX task's state tree, optax RMSprop states after two updates)
  resumes in the port with both RMSprop states bit-identical.
- ``--infer`` with ``infer_hubert_npy`` runs the port's ``PostnetInfer`` on
  the port-trained VAE and post-net.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from geneface_tpu_torch.convert import flax_variables
from geneface_tpu_torch.tasks.run import main
from geneface_tpu_torch.utils.checkpoint import get_last_checkpoint, load_checkpoint
from tools.make_synthetic_lrs3 import make_lrs3
from torch_audio_helpers import flat as _flat

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(config, exp, hparams, *extra):
    return main(["--config", os.path.join(REPO, config), "--exp_name", exp, "--device", "cpu",
                 "--hparams", hparams, *extra])


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("chain")
    data = make_lrs3(str(root / "lrs3"), n_train=6, n_val=2)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        common = (f"data_dir={data},lrs3_data_dir={data},max_updates=2,val_check_interval=2,"
                  "tb_log_interval=1,num_sanity_val_steps=1,eval_max_batches=1,"
                  "max_tokens=1000,syncnet_num_samples_per_batch=16")
        assert _run("egs/datasets/lrs3/lm3d_syncnet.yaml", "sync", common) == 2
        sync = str(root / "checkpoints" / "sync")
        sync_before = load_checkpoint(get_last_checkpoint(sync))["state"]["params"]
        assert _run("egs/datasets/lrs3/lm3d_vae_sync.yaml", "vae",
                    common + f",syncnet_work_dir={sync}") == 2
        vae = str(root / "checkpoints" / "vae")
        assert _run("egs/datasets/videos/May/lm3d_postnet_sync.yaml", "postnet",
                    common + f",syncnet_work_dir={sync},audio2motion_work_dir={vae}") == 2
    finally:
        os.chdir(cwd)
    return {"root": root, "data": data, "sync": sync, "vae": vae,
            "postnet": str(root / "checkpoints" / "postnet"), "sync_before": sync_before}


def test_the_chain_trains_through_run(chain):
    for name, loss in (("sync", "tr/sync_loss"), ("vae", "tr/kl"), ("postnet", "tr/adv")):
        rows = [json.loads(x) for x in open(os.path.join(chain[name], "metrics.jsonl"))]
        tr = [r for r in rows if loss in r]
        assert [r["step"] for r in tr] == [1, 2], name
        assert all(np.isfinite(v) for r in rows for k, v in r.items() if k != "step"), name
    ck = {n: load_checkpoint(get_last_checkpoint(chain[n])) for n in ("sync", "vae", "postnet")}
    assert sorted(ck["sync"]["state"]) == sorted(ck["vae"]["state"]) == ["opt_state", "params"]
    assert sorted(ck["postnet"]["state"]) == ["disc_opt", "disc_params", "gen_opt", "gen_params"]
    assert ck["vae"]["extra"] == {"enable_sync": False}
    assert ck["postnet"]["extra"] == {"task_step": 2}
    assert int(ck["postnet"]["state"]["gen_opt"]["count"]) == 2
    assert int(ck["sync"]["state"]["opt_state"]["count"]) == 2
    # the frozen upstreams did not move while their dependants trained
    after = _flat(load_checkpoint(get_last_checkpoint(chain["sync"]))["state"]["params"])
    for k, v in _flat(chain["sync_before"]).items():
        np.testing.assert_array_equal(after[k], v)


def test_jax_postnet_task_builds_on_the_port_syncnet_and_vae(chain):
    """The JAX post-net task takes the port's SyncNet and VAE runs as its
    frozen upstreams (the JAX VAE task reads ``syncnet_work_dir`` with the
    same lines, ``tasks/audio2motion.py:71-76``; its own ``build`` spends
    ~14 s in an eager flax init of the VAE), holding their parameters
    exactly (the towers' parity is ``test_torch_syncnet.py``'s, the VAE's
    ``test_torch_audio2motion.py``'s)."""
    from geneface_tpu.tasks.postnet import PostnetAdvSyncTask as JTask

    jt = JTask(dict(lrs3_data_dir=chain["data"], syncnet_work_dir=chain["sync"],
                    audio2motion_work_dir=chain["vae"], seed=1, lr=1e-3, scheduler="none",
                    max_tokens=1000))
    state = jt.build()
    assert sorted(state) == ["disc_opt", "disc_params", "gen_opt", "gen_params"]
    for held, upstream in ((jt.sync_params, chain["sync"]), (jt.vae_params, chain["vae"])):
        want = _flat(load_checkpoint(get_last_checkpoint(upstream))["state"]["params"])
        got = _flat(jax.tree_util.tree_map(np.asarray, held))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_jax_postnet_checkpoint_resumes_with_its_rmsprop_state(chain, tmp_path):
    import optax

    from geneface_tpu.training.optim import finalize_optimizer
    from geneface_tpu.training.schedules import build_schedule
    from geneface_tpu.utils.checkpoint import save_checkpoint as jax_save
    from geneface_tpu_torch.models.postnet.models import CNNPostNet, MLPDiscriminator
    from geneface_tpu_torch.tasks.postnet import PostnetAdvSyncTask
    from geneface_tpu_torch.training.trainer import Trainer

    cfg = dict(lrs3_data_dir=chain["data"], syncnet_work_dir=chain["sync"],
               audio2motion_work_dir=chain["vae"], seed=2, lr=1e-3, scheduler="none",
               max_tokens=1000, syncnet_num_samples_per_batch=8, postnet_disc_lr_ratio=0.5,
               work_dir=str(tmp_path / "resume"), max_updates=3, val_check_interval=3,
               tb_log_interval=1, num_sanity_val_steps=0, eval_max_batches=1)
    schedule = build_schedule(cfg)
    gen_tx = finalize_optimizer(optax.rmsprop(schedule), cfg)
    disc_tx = finalize_optimizer(optax.rmsprop(lambda s: schedule(s) * 0.5), cfg)
    rng = np.random.RandomState(3)
    state = {}
    for key, model, tx in (("gen", CNNPostNet(204), gen_tx), ("disc", MLPDiscriminator(204),
                                                              disc_tx)):
        p = flax_variables(model)
        s = tx.init(p)
        update = jax.jit(tx.update)
        for _ in range(2):
            g = jax.tree_util.tree_map(lambda x: rng.randn(*x.shape).astype(np.float32), p)
            u, s = update(g, s, p)
            p = optax.apply_updates(p, u)
        state[f"{key}_params"], state[f"{key}_opt"] = p, s
    jax_save(os.path.join(cfg["work_dir"], "model_ckpt_steps_2.ckpt"),
             {"step": 2, "state": state, "extra": {"task_step": 2}})
    task = PostnetAdvSyncTask(cfg, device="cpu")
    seen = {}
    real = task.on_restore

    def record(extra):
        real(extra)
        seen.update(gen=task.gen_opt.state_dict(), disc=task.disc_opt.state_dict(),
                    gen_params=flax_variables(task.model), step=task._step)

    task.on_restore = record
    assert Trainer(task).fit() == 3
    assert seen["step"] == 2
    for key in ("gen", "disc"):
        ref = state[f"{key}_opt"]
        rms, sched = ref.inner_state[0], ref.inner_state[1]
        assert int(seen[key]["count"]) == int(sched.count) == 2
        assert int(seen[key]["skipped"]) == int(ref.total_notfinite) == 0
        want = _flat(jax.tree_util.tree_map(np.asarray, rms.nu))
        got = _flat(seen[key]["nu"])
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    got = _flat(seen["gen_params"])
    for k, v in _flat(jax.tree_util.tree_map(np.asarray, state["gen_params"])).items():
        np.testing.assert_array_equal(got[k], v)
    after = load_checkpoint(os.path.join(cfg["work_dir"], "model_ckpt_steps_3.ckpt"))
    assert int(after["state"]["gen_opt"]["count"]) == 3 and after["extra"] == {"task_step": 3}


def test_postnet_infer_on_the_port_trained_checkpoints(chain, tmp_path):
    hubert = np.random.RandomState(4).randn(70, 1024).astype(np.float32)
    np.save(tmp_path / "hubert.npy", hubert)
    out = tmp_path / "pred_lm3d.npy"
    cwd = os.getcwd()
    os.chdir(chain["root"])
    try:
        _run("egs/datasets/videos/May/lm3d_postnet_sync.yaml", "postnet",
             f"audio2motion_work_dir={chain['vae']},postnet_work_dir={chain['postnet']},"
             f"infer_hubert_npy={tmp_path / 'hubert.npy'},infer_out_npy_name={out}", "--infer")
    finally:
        os.chdir(cwd)
    lm3d = np.load(out)
    assert lm3d.shape == (1, 32, 68, 3) and np.isfinite(lm3d).all()  # 70 rows → 64 → 32 frames
    assert np.abs(lm3d).max() > 0


def test_jax_written_syncnet_and_vae_runs_load_in_the_port(chain, tmp_path):
    """SyncNet and VAE runs written by the JAX package's checkpoint writer
    in its tasks' layout (``{"params", "opt_state"}``, optax's
    ``apply_if_finite(adam)`` state after one update): the port's VAE task
    takes the SyncNet as its frozen upstream, resumes the VAE run with its
    Adam moments bit-identical, and the post-net task's loader takes the
    VAE."""
    import optax

    from geneface_tpu.training.optim import finalize_optimizer
    from geneface_tpu.utils.checkpoint import save_checkpoint as jax_save
    from geneface_tpu_torch.models.audio2motion.vae import VAEModel
    from geneface_tpu_torch.models.syncnet.models import LandmarkHubertSyncNet
    from geneface_tpu_torch.tasks.audio2motion import VAESyncAudio2MotionTask
    from geneface_tpu_torch.tasks.syncnet import load_frozen
    from geneface_tpu_torch.training.trainer import Trainer

    cfg = dict(data_dir=chain["data"], lrs3_data_dir=chain["data"], seed=3, lr=1e-3,
               scheduler="none", max_tokens=1000, syncnet_num_samples_per_batch=8,
               tb_log_interval=1, num_sanity_val_steps=0, eval_max_batches=1)
    rng = np.random.RandomState(5)
    written = {}
    for name, model in (("sync", LandmarkHubertSyncNet()), ("vae", VAEModel(in_out_dim=204))):
        params = jax.tree_util.tree_map(
            lambda x: (x + 0.01 * rng.randn(*x.shape)).astype(np.float32), flax_variables(model))
        tx = finalize_optimizer(optax.adam(1e-3), cfg)
        opt_state = tx.init(params)
        if name == "vae":  # the resumed run's moments after one update
            g = jax.tree_util.tree_map(lambda x: rng.randn(*x.shape).astype(np.float32), params)
            _, opt_state = jax.jit(tx.update)(g, opt_state, params)
        jax_save(os.path.join(tmp_path, name, "model_ckpt_steps_1.ckpt"),
                 {"step": 1, "state": {"params": params, "opt_state": opt_state},
                  "extra": {"enable_sync": True} if name == "vae" else {}})
        written[name] = (params, opt_state)
    sync_dir, vae_dir = str(tmp_path / "sync"), str(tmp_path / "vae")
    task = VAESyncAudio2MotionTask(dict(cfg, syncnet_work_dir=sync_dir, work_dir=vae_dir,
                                        max_updates=1), device="cpu")
    seen = {}
    real = task.on_restore

    def record(extra):
        real(extra)
        seen.update(opt=task.optimizer.state_dict(), enable_sync=task.enable_sync,
                    sync=flax_variables(task.syncnet))

    task.on_restore = record
    assert Trainer(task).fit() == 1  # restored at its last step
    assert seen["enable_sync"] is True
    got = _flat(seen["sync"])
    for k, v in _flat(written["sync"][0]).items():
        np.testing.assert_array_equal(got[k], v)
    adam = written["vae"][1].inner_state[0]
    assert int(seen["opt"]["count"]) == int(adam.count) == 1
    for key in ("mu", "nu"):
        want = _flat(jax.tree_util.tree_map(np.asarray, getattr(adam, key)))
        got = _flat(seen["opt"][key])
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    # the post-net task's loader on the JAX-written VAE checkpoint itself
    vae = load_frozen(VAEModel(in_out_dim=204), os.path.join(vae_dir, "model_ckpt_steps_1.ckpt"),
                      "cpu")
    got = _flat(flax_variables(vae))
    for k, v in _flat(written["vae"][0]).items():
        np.testing.assert_array_equal(got[k], v)
