"""The port's vanilla NeRF tasks end to end on the CPU (32² synthetic scene,
hidden 32, ``cond_dim`` 16, 8+8 samples, 64 rays): ``Trainer.fit`` with its
metrics, checkpoints and resume; a JAX-written checkpoint with optax's Adam
state resumed in the port; the port's checkpoint rendered by the JAX
renderer; and ``tasks.run`` training the lm3d head and torso and ADNeRF from
YAMLs on ``egs/egs_bases/nerf/*.yaml``, then ``--infer`` to an mp4 for the
lm3d head, the lm3d head+torso and the ADNeRF head.

Tolerances: the resumed Adam moments and count equal to the checkpoint's;
the next update within atol 1e-7 + rtol 1e-6 of optax's on the same
gradient; the JAX renderer's frame of the port's checkpoint within 1e-5 of
max |ref| of the port's.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from geneface_tpu.config import Config as JConfig
from geneface_tpu.inference.nerf_infer import LM3dNeRFInfer as JInfer
from geneface_tpu.tasks.lm3d_nerf import Lm3dNeRFTask as JTask
from geneface_tpu.utils.checkpoint import save_checkpoint as jsave
from geneface_tpu_torch.convert import nerf_flax_to_state_dict, nerf_state_dict_to_flax
from geneface_tpu_torch.inference.nerf_infer import LM3dNeRFInfer
from geneface_tpu_torch.tasks.lm3d_nerf import Lm3dNeRFTask
from geneface_tpu_torch.tasks.run import main
from geneface_tpu_torch.training.trainer import Trainer
from geneface_tpu_torch.utils.checkpoint import load_checkpoint

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.make_synthetic_dataset import make_dataset  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(cond_win_size=1, smo_win_size=3, cond_dim=16, hidden_size=32, n_rays=64,
            n_samples_per_ray=8, n_samples_per_ray_fine=8, lr=5e-3, max_updates=4,
            val_check_interval=2, tb_log_interval=2, num_sanity_val_steps=1,
            eval_max_batches=1, num_ckpt_keep=2, no_smo_iterations=2, max_ray_batch=512, seed=0)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("nerf_run"))
    make_dataset(d, n_frames=10, hw=32)
    return d


def tiny_cfg(data, work, **over):
    cfg = dict(TINY, data_dir=data, work_dir=work, cond_type="idexp_lm3d_normalized",
               with_att=True, near=0.3, far=0.9, scheduler="exponential")
    cfg.update(over)
    return cfg


def flat(tree, pre=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, pre + (k,)))
        else:
            out[pre + (k,)] = np.asarray(v)
    return out


def test_fit_metrics_checkpoints_and_resume(synth, tmp_path):
    work = str(tmp_path / "head")
    cfg = tiny_cfg(synth, work)
    assert Trainer(Lm3dNeRFTask(cfg, device="cpu")).fit() == 4
    lines = [json.loads(line) for line in open(os.path.join(work, "metrics.jsonl"))]
    tr = [line for line in lines if "tr/mse_loss" in line]
    assert {"tr/mse_loss", "tr/mse_loss_coarse", "tr/total_loss", "tr/psnr"} <= set(tr[-1])
    assert np.isfinite(tr[-1]["tr/total_loss"])
    assert any("val/psnr" in line for line in lines)
    names = sorted(os.listdir(work))
    assert {"model_ckpt_steps_2.ckpt", "model_ckpt_steps_4.ckpt", "model_ckpt_best.ckpt",
            "config.yaml"} <= set(names)
    ckpt = load_checkpoint(os.path.join(work, "model_ckpt_steps_4.ckpt"))
    assert ckpt["step"] == 4 and ckpt["extra"] == {"task_step": 4}
    assert {"lm_encoder", "lmatt_encoder", "model_coarse", "model_fine"} == set(
        ckpt["state"]["params"]["params"])
    assert int(ckpt["state"]["opt_state"]["count"]) == 4
    # a fresh Trainer resumes at step 4 with the checkpoint's moments
    task = Lm3dNeRFTask(dict(cfg, max_updates=6), device="cpu")
    task.build()
    task.restore_state(ckpt["state"])
    task.on_restore(ckpt["extra"])
    assert task._step == 4 and task.with_att()
    got = task.optimizer.state_dict()
    for key in ("mu", "nu"):
        want = flat(ckpt["state"]["opt_state"][key])
        mine = flat(got[key])
        assert set(want) == set(mine)
        for k in want:
            np.testing.assert_array_equal(mine[k], want[k])
    assert Trainer(Lm3dNeRFTask(dict(cfg, max_updates=6), device="cpu")).fit() == 6
    assert os.path.exists(os.path.join(work, "model_ckpt_steps_6.ckpt"))
    assert not os.path.exists(os.path.join(work, "model_ckpt_steps_2.ckpt"))


def test_jax_checkpoint_resumes_and_port_checkpoint_renders_in_jax(synth, tmp_path):
    """A JAX-layout checkpoint with optax's multi-group Adam state after two
    updates resumes in the port and takes the same third update as optax;
    the JAX renderer renders the port's saved parameters as the port does."""
    work = str(tmp_path / "jax_head")
    cfg = tiny_cfg(synth, work)
    jtask = JTask(JConfig(cfg))
    state = jtask.build()
    rng = np.random.RandomState(0)
    params = state["params"]

    def grads_like(p):
        return jax.tree_util.tree_map(
            lambda v: jnp.asarray(rng.randn(*v.shape).astype(np.float32) * 1e-2), p)

    opt = state["opt_state"]
    for _ in range(2):
        upd, opt = jtask.tx.update(grads_like(params), opt, params)
        params = optax.apply_updates(params, upd)
    np_tree = jax.tree_util.tree_map(np.asarray, {"params": params, "opt_state": opt})
    jsave(os.path.join(work, "model_ckpt_steps_2.ckpt"),
          {"step": 2, "state": np_tree, "extra": {"task_step": 2}})

    task = Lm3dNeRFTask(cfg, device="cpu")
    task.build()
    ckpt = load_checkpoint(os.path.join(work, "model_ckpt_steps_2.ckpt"))
    task.restore_state(ckpt["state"])
    assert int(task.optimizer.count) == 2
    g = grads_like(params)
    upd, _ = jtask.tx.update(g, opt, params)
    ref = flat(jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, upd)))
    sd = nerf_flax_to_state_dict(jax.tree_util.tree_map(np.asarray, g))
    for n, p in task.model.named_parameters():
        p.grad = torch.as_tensor(sd[n])
    task.optimizer.step()
    now = flat(nerf_state_dict_to_flax(task.model.state_dict()))
    for k in ref:
        np.testing.assert_allclose(now[k], ref[k], atol=1e-7, rtol=1e-6, err_msg=str(k))

    # the port's checkpoint, rendered by the JAX renderer (eagerly: see
    # tests/test_torch_nerf_infer.py)
    pwork = str(tmp_path / "port_head")
    pcfg = tiny_cfg(synth, pwork, max_updates=2)
    Trainer(Lm3dNeRFTask(pcfg, device="cpu")).fit()
    infer = LM3dNeRFInfer(pcfg, device="cpu")
    conds = infer.dataset.conds
    got = infer.render_frame(1, conds)
    jinfer = JInfer(JConfig(pcfg))
    jinfer._chunk_jit = jinfer._render_chunk
    ref = jinfer.render_frame(1, conds)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def _yaml(tmp_path, name, base, **keys):
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(dict(
        keys, base_config=[os.path.join(REPO, "egs/egs_bases/nerf", base)])))
    return str(path)


def test_run_cli_trains_and_infers(synth, tmp_path):
    """``tasks.run`` from the shipped base configs: the lm3d head, its torso
    and ADNeRF train 2 steps each; ``--infer`` writes an mp4 for the lm3d
    head, the head+torso and ADNeRF."""
    keys = dict(TINY, data_dir=synth, max_updates=2, num_sanity_val_steps=0)
    head, torso, ad = (str(tmp_path / k) for k in ("head", "torso", "ad"))
    npy = str(tmp_path / "pred.npy")
    ds = np.load(os.path.join(synth, "trainval_dataset.npy"), allow_pickle=True).tolist()
    np.save(npy, (ds["idexp_lm3d_mean"][None] + 0.5 * ds["idexp_lm3d_std"][None]
                  * np.random.RandomState(1).randn(3, 68, 3)).reshape(1, 3, 204))
    ds_npy = str(tmp_path / "ds.npy")
    np.save(ds_npy, np.random.RandomState(2).randn(2, 16, 29).astype(np.float32))
    runs = [
        (_yaml(tmp_path, "head", "lm3d_nerf.yaml", **keys), head, npy),
        (_yaml(tmp_path, "torso", "lm3d_nerf_torso.yaml", head_model_dir=head, **keys), torso,
         npy),
        (_yaml(tmp_path, "ad", "adnerf.yaml", **dict(keys, smo_win_size=8)), ad, ds_npy),
    ]
    for config, work, cond in runs:
        assert main(["--config", config, "--exp_name", work, "--device", "cpu"]) == 2
        assert os.path.exists(os.path.join(work, "model_ckpt_steps_2.ckpt"))
        out = str(tmp_path / "videos" / f"{os.path.basename(work)}.mp4")
        assert main(["--config", config, "--exp_name", work, "--device", "cpu", "--infer",
                     "--hparams", f"infer_cond_name={cond},infer_out_video_name={out},"
                                  "infer_n_frames=2"]) == 0
        assert os.path.getsize(out) > 0
    saved = load_checkpoint(os.path.join(torso, "model_ckpt_steps_2.ckpt"))["state"]["params"]
    assert "color_encoder_0" in saved["params"] and "model_fine" in saved["params"]
