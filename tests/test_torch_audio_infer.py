"""The slice as a whole on the CPU: a seeded voiced wav on disk → HuBERT
(a converted checkpoint at ``GF_HUBERT_CKPT``) and f0 → the Audio2Motion
VAE's prior sample → the post-net → lm3d, the port's ``PostnetInfer``
against the JAX one; then the LLE'd condition windows of a tiny RAD-NeRF
scene from that lm3d; then the CLI: the post-net config's ``--infer``
writes the ``[1, T, 68, 3]`` ``.npy`` and the RAD-NeRF ``--infer`` renders
a video from it.

Sizes: a 1 s wav; a HuBERT of width 1024 (the VAE's input width) with one
layer and 8-channel convs at the full stride 320; the VAE and the post-net
at full width; every leaf of the three from a seeded generator (the flow's
output convs non-zero), converted to the flax layout and written by the
JAX package's ``save_checkpoint``. The port gets the JAX prior noise.
Tolerance: lm3d to 1e-4 of its largest magnitude (float32 through HuBERT,
the VAE and the post-net, sums in another order). The condition windows
to 1e-4 absolute (normalized landmarks): the synthetic scene's landmark
database has rank 2 (one signal drives it), so the LLE's 9 × 9 Gram matrix
is singular but for its ridge (1e-6 of its trace), and the JAX package's
float32 Gram products round by about as much as the ridge; the port solves
in float64 (``tests/test_torch_postnet.py``).
"""

import dataclasses
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from geneface_tpu.config import Config as JConfig
from geneface_tpu.inference.audio2motion_infer import Audio2MotionInfer as JAudio2MotionInfer
from geneface_tpu.datagen.wav2vec2 import Wav2Vec2Config as JW2VConfig
from geneface_tpu.inference.postnet_infer import PostnetInfer as JPostnetInfer
from geneface_tpu.inference.radnerf_infer import RADNeRFInfer as JInfer
from geneface_tpu.utils.checkpoint import save_checkpoint as jsave
from geneface_tpu_torch.convert import flax_variables, state_dict_to_flax
from geneface_tpu_torch.datagen.wav2vec2 import Wav2Vec2Config, Wav2Vec2CTC
from geneface_tpu_torch.inference import Audio2MotionInfer, PostnetInfer, RADNeRFInfer
from geneface_tpu_torch.models.audio2motion.vae import PitchContourVAEModel, VAEModel
from geneface_tpu_torch.models.layers import init_weights_
from geneface_tpu_torch.models.postnet.models import CNNPostNet, PitchContourCNNPostNet
from geneface_tpu_torch.models.radnerf import model_from_cfg
from geneface_tpu_torch.tasks import run
from test_torch_infer import _cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import planted_occupancy, write_voiced_wav  # noqa: E402
from tools.make_synthetic_dataset import make_dataset  # noqa: E402

HUBERT = dict(
    vocab_size=0, hidden_size=1024, num_hidden_layers=1, num_attention_heads=4,
    intermediate_size=64, conv_dim=(8,) * 7, conv_stride=(5, 2, 2, 2, 2, 2, 2),
    conv_kernel=(10, 3, 3, 3, 3, 2, 2), num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4,
)
PITCH_TASK = "geneface_tpu.tasks.audio2motion.PitchContourVAESyncTask"


@pytest.fixture(scope="module")
def stage_a(tmp_path_factory):
    """The wav, and the three checkpoints in the JAX layout: seeded weights
    of the port's models (every leaf random, the flow's output convs too)
    through ``flax_variables``, written by the JAX ``save_checkpoint``."""
    root = tmp_path_factory.mktemp("audio_infer")
    wav = str(root / "speech.wav")
    write_voiced_wav(wav, 1.0)
    gen = torch.Generator().manual_seed(0)
    hubert = init_weights_(Wav2Vec2CTC(Wav2Vec2Config(**HUBERT)), gen)
    with open(root / "hubert.pkl", "wb") as f:
        pickle.dump({"config": dataclasses.asdict(JW2VConfig(**HUBERT)),
                     "params": flax_variables(hubert)}, f)
    dirs = {}
    for pitch in (False, True):
        vae = (PitchContourVAEModel if pitch else VAEModel)(in_out_dim=204)
        pn = PitchContourCNNPostNet(204, 64) if pitch else CNNPostNet(204)
        d = dirs[pitch] = (str(root / f"vae_{pitch}"), str(root / f"postnet_{pitch}"))
        jsave(os.path.join(d[0], "model_ckpt_steps_40000.ckpt"),
              {"state": {"params": flax_variables(init_weights_(vae, gen))}})
        jsave(os.path.join(d[1], "model_ckpt_steps_6000.ckpt"),
              {"state": {"gen_params": flax_variables(init_weights_(pn, gen))}})
    return root, wav, dirs


def postnet_cfg(stage_a, pitch):
    root, wav, dirs = stage_a
    cfg = dict(audio2motion_work_dir=dirs[pitch][0], postnet_work_dir=dirs[pitch][1],
               work_dir="", postnet_norm="ln")
    if pitch:
        cfg["audio2motion_task_cls"] = PITCH_TASK
    return cfg


@pytest.mark.parametrize("pitch", [False, True], ids=["vae", "pitch_vae"])
def test_postnet_infer_matches_jax(stage_a, pitch, monkeypatch):
    root, wav, _ = stage_a
    monkeypatch.setenv("GF_HUBERT_CKPT", str(root / "hubert.pkl"))
    cfg = postnet_cfg(stage_a, pitch)
    jinf = JPostnetInfer(JConfig(cfg))
    ref = jinf.infer(wav_path=wav, seed=3, temperature=0.8)
    inf = PostnetInfer(cfg, device="cpu")
    hubert, f0 = inf.get_cond_from_input(wav)
    assert hubert.shape == (96, 1024) and f0.shape == (96,)
    assert (f0 > 0).mean() > 0.5  # voiced
    shape = inf.vae.noise_shape(1, len(hubert) // 2)
    noise = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(3), shape)))
    ours = inf.infer(wav_path=wav, noise=noise, temperature=0.8)
    assert ours.shape == ref.shape == (48, 68, 3)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_audio2motion_infer_matches_jax(stage_a, tmp_path):
    """The VAE alone from pre-extracted HuBERT rows; ``.npy`` as ``[1, T, 204]``."""
    cfg = {"audio2motion_work_dir": stage_a[2][False][0]}
    hubert = np.random.RandomState(6).randn(64, 1024).astype(np.float32)
    ref = JAudio2MotionInfer(JConfig(cfg)).infer(hubert=hubert, seed=4)
    inf = Audio2MotionInfer(cfg, device="cpu")
    noise = torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(4), inf.model.noise_shape(1, 32))))
    out = str(tmp_path / "a2m.npy")
    ours = inf.infer(hubert=hubert, noise=noise, out_npy=out)
    assert ours.shape == ref.shape == (32, 68, 3) and np.load(out).shape == (1, 32, 204)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 32² 12-frame synthetic video and a seeded head checkpoint (the
    port's init in the JAX layout, the occupancy ball of radius 0.6)."""
    root = tmp_path_factory.mktemp("audio_scene")
    data = str(root / "data")
    make_dataset(data, n_frames=12, hw=32)
    work = str(root / "checkpoints" / "head")
    cfg = _cfg(data, work)
    model = model_from_cfg(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    jsave(os.path.join(work, "model_ckpt_steps_0.ckpt"),
          {"state": {"params": state_dict_to_flax(model.state_dict()),
                     "occ": planted_occupancy(cfg["grid_size"], 10.0)}, "step": 0})
    return root, cfg


def test_conds_from_predicted_lm3d_with_lle_match_jax(stage_a, scene):
    _, cfg0 = scene
    cfg = {**cfg0, "infer_lm3d_lle_percent": 0.7}
    inf = RADNeRFInfer(cfg, device="cpu", dtype=torch.float32)
    jinf = JInfer(JConfig(cfg))
    rng = np.random.RandomState(5)
    lm3d = np.asarray(jinf.dataset.idexp_lm3d_mean) + rng.randn(20, 68, 3).astype(np.float32) * 0.05
    ours, ref = inf.conds_from_lm3d(lm3d), jinf.conds_from_lm3d(lm3d)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
    plain = RADNeRFInfer(cfg0, device="cpu", dtype=torch.float32).conds_from_lm3d(lm3d)
    assert np.abs(ours - plain).max() > 1e-2  # the projection moved them


def test_cli_speech_to_video(stage_a, scene, monkeypatch):
    """``--infer`` of the post-net config writes ``[1, T, 68, 3]``; the
    RAD-NeRF ``--infer`` renders 2 frames from it, LLE on."""
    root, wav, _ = stage_a
    sroot, cfg = scene
    monkeypatch.setenv("GF_HUBERT_CKPT", str(root / "hubert.pkl"))
    monkeypatch.chdir(sroot)
    npy = str(sroot / "pred_lm3d.npy")
    pcfg = postnet_cfg(stage_a, False)
    hp = (f"audio2motion_work_dir={pcfg['audio2motion_work_dir']},"
          f"postnet_work_dir={pcfg['postnet_work_dir']},infer_audio_source_name={wav},"
          f"infer_out_npy_name={npy}")
    yaml_path = os.path.join(REPO, "egs/datasets/videos/May/lm3d_postnet_sync.yaml")
    assert run.main(["--config", yaml_path, "--infer", "--device", "cpu", "--hparams", hp]) == 0
    lm3d = np.load(npy)
    assert lm3d.shape == (1, 48, 68, 3) and np.isfinite(lm3d).all()

    head_yaml = sroot / "head.yaml"
    keys = {**cfg, "infer_cond_name": npy, "infer_out_video_name": str(sroot / "out.mp4"),
            "infer_n_frames": 2, "infer_lm3d_lle_percent": 1.0}
    keys.pop("work_dir")
    head_yaml.write_text(
        f"base_config:\n  - {REPO}/egs/egs_bases/radnerf/lm3d_radnerf.yaml\n"
        + "".join(f"{k}: {v!r}\n" if isinstance(v, str) else f"{k}: {v}\n"
                  for k, v in keys.items()))
    assert run.main(["--config", str(head_yaml), "--exp_name", "head", "--infer",
                     "--device", "cpu"]) == 0
    assert os.path.getsize(sroot / "out.mp4") > 0
