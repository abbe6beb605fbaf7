"""The port's vanilla NeRF inference against the JAX package's
``LM3dNeRFInfer``/``ADNeRFInfer`` on JAX-written checkpoints (seeded JAX
parameters, a 32² synthetic scene, hidden 32, ``cond_dim`` 16, 8+8
samples): the conditions from a predicted lm3d (clamp, blinks, smoothing,
the LLE projection, the closed mouth on a silent wav), a head frame, a
head+torso frame, an ADNeRF frame from a seeded DeepSpeech ``.npy``, and the
mp4 each renderer writes.

The JAX renderers render their chunks eagerly here (``_chunk_jit`` set to the
plain function): eager XLA rounds ``o + d·z`` as the port does, while the
jitted chunk fuses some of those multiply-adds. The JAX head+torso frame
cannot run as the JAX renderer calls it (its ``[1, 3]`` pose slices do not
broadcast in ``ADNeRFTorso``; ``test_jax_torso_frame_fault``): it is
rendered through the JAX renderer's own chunk function with the frame's
``[3]`` pose, as training passes it.

Tolerances: frames within 1e-5 of max |ref|; conditions bit for bit
without the LLE projection, within 1e-4 with it (the JAX projection solves
in float32, the port's in float64: ROADMAP Queue 3).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from geneface_tpu.config import Config as JConfig
from geneface_tpu.inference.nerf_infer import ADNeRFInfer as JADInfer
from geneface_tpu.inference.nerf_infer import LM3dNeRFInfer as JInfer
from geneface_tpu.models.nerf import ADNeRF as JADNeRF
from geneface_tpu.models.nerf import ADNeRFTorso as JTorso
from geneface_tpu.models.nerf import Lm3dNeRF as JLm3d
from geneface_tpu.utils.checkpoint import save_checkpoint as jsave
from geneface_tpu_torch.inference.nerf_infer import ADNeRFInfer, LM3dNeRFInfer

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.make_synthetic_dataset import make_dataset  # noqa: E402

torch.set_num_threads(1)

FWD = 1e-5


def close(got, ref, bound=FWD):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= bound * scale, np.abs(got - ref).max() / scale


def seeded(jmodel, cond, seed):
    """JAX-initialised parameters, non-zero biases, sigma biases at 3 (a
    translucent field)."""
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(cond), jnp.zeros((4, 8, 3)),
                         jnp.zeros((4, 3)), method=jmodel.init_all)
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda v: np.array(v) + (0.05 * rng.randn(*v.shape).astype(np.float32)
                                 if v.ndim == 1 else 0), params)
    for net in ("model_coarse", "model_fine"):
        params["params"][net]["Dense_8"]["bias"][:] = 3.0
    return params


def base_cfg(data, **over):
    cfg = dict(data_dir=data, cond_type="idexp_lm3d_normalized", cond_win_size=1,
               smo_win_size=3, cond_dim=16, hidden_size=32, with_att=True, near=0.3, far=0.9,
               n_samples_per_ray=8, n_samples_per_ray_fine=8, max_ray_batch=384, seed=0)
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The scene and JAX-written checkpoints: an lm3d head, an lm3d torso
    (colour on) and an ADNeRF head."""
    root = tmp_path_factory.mktemp("nerf_infer")
    data = str(root / "data")
    make_dataset(data, n_frames=10, hw=32)
    dirs = {k: str(root / k) for k in ("head", "torso", "adnerf")}
    for name, model, cond, seed in (
        ("head", JLm3d(cond_dim=16, hidden_size=32, smo_win_size=3), np.zeros((3, 1, 204)), 1),
        ("torso", JTorso(cond_dim=16, hidden_size=32, use_color=True, cond_win_size=1,
                         smo_win_size=3), np.zeros((3, 1, 204)), 2),
        ("adnerf", JADNeRF(cond_dim=16, hidden_size=32), np.zeros((8, 16, 29)), 3),
    ):
        jsave(os.path.join(dirs[name], "model_ckpt_steps_5.ckpt"),
              {"state": {"params": seeded(model, cond.astype(np.float32), seed)}, "step": 5})
    return data, dirs


def pred_lm3d(data, T, seed=0):
    ds = np.load(os.path.join(data, "trainval_dataset.npy"), allow_pickle=True).tolist()
    return (ds["idexp_lm3d_mean"][None]
            + 0.8 * ds["idexp_lm3d_std"][None] * np.random.RandomState(seed).randn(T, 68, 3))


def eager(jinfer):
    jinfer._chunk_jit = jinfer._render_chunk
    return jinfer


def test_conds_match_jax(scene, tmp_path):
    data, dirs = scene
    lm = pred_lm3d(data, 12)
    over = dict(infer_lm3d_clamp_std=1.5, infer_inject_eye_blink_mode="gt",
                infer_lm3d_smooth_sigma=1.0, work_dir=dirs["head"])
    got = LM3dNeRFInfer(base_cfg(data, **over), device="cpu").get_conds(lm)
    ref = JInfer(JConfig(base_cfg(data, **over))).get_conds(lm)
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (12, 1, 204)
    # the LLE projection: float64 here, float32 in JAX
    over.update(infer_lm3d_lle_percent=0.5)
    got = LM3dNeRFInfer(base_cfg(data, **over), device="cpu").get_conds(lm)
    ref = JInfer(JConfig(base_cfg(data, **over))).get_conds(lm)
    close(got, ref, 1e-4)
    # a silent wav closes every mouth (the JAX renderer's transposed mel)
    wav = str(tmp_path / "silence.wav")
    wavfile.write(wav, 16000, np.zeros(8000, np.int16))
    over = dict(infer_close_mouth_when_sil=True, infer_sil_ref_frame_idx=2,
                work_dir=dirs["head"])
    got = LM3dNeRFInfer(base_cfg(data, **over), device="cpu").get_conds(lm, wav_path=wav)
    np.testing.assert_array_equal(
        got, JInfer(JConfig(base_cfg(data, **over))).get_conds(lm, wav_path=wav))
    plain = LM3dNeRFInfer(base_cfg(data, work_dir=dirs["head"]), device="cpu").get_conds(lm)
    mouth = got.reshape(12, 68, 3)[:, 48:]
    assert not np.array_equal(mouth, plain.reshape(12, 68, 3)[:, 48:])
    assert np.all(mouth == mouth[:1])


def test_head_frame_matches_jax(scene):
    """A JAX-written head checkpoint renders the same frame in the port."""
    data, dirs = scene
    cfg = base_cfg(data, work_dir=dirs["head"])
    infer = LM3dNeRFInfer(cfg, device="cpu")
    conds = infer.get_conds(pred_lm3d(data, 4))
    got = infer.render_frame(2, conds)
    ref = eager(JInfer(JConfig(cfg))).render_frame(2, conds)
    assert got.shape == (32, 32, 3)
    close(got, ref)


def _jax_torso_frame(jinfer, frame_idx, conds):
    """The JAX renderer's chunk function over a frame, with the frame's
    ``[3]`` pose (its ``render_frame`` passes ``[1, 3]``)."""
    from geneface_tpu.data.radnerf_dataset import get_cond_window

    ds = jinfer.dataset
    item = ds[frame_idx]
    ro_t, rd_t, _ = ds.full_sampler(ds.H, ds.W, ds.focal, ds.c2w_t0, cx=ds.cx, cy=ds.cy)
    rays = (item["rays_o"], item["rays_d"], ro_t.astype(np.float32), rd_t.astype(np.float32))
    cond_wins = jnp.asarray(get_cond_window(conds, frame_idx, 3))
    cond1 = jnp.asarray(conds[frame_idx][None])
    rgb = jinfer._render_chunk(
        (jinfer.params, jinfer.head_params), tuple(jnp.asarray(a) for a in rays),
        jnp.asarray(item["bg_img"]), cond_wins, cond1, jnp.asarray(ds.eulers[frame_idx]),
        jnp.asarray(ds.transs[frame_idx]))
    return np.asarray(rgb).reshape(ds.H, ds.W, 3)


def test_head_torso_frame_matches_jax(scene):
    """Head rays at the frame's pose, torso rays at ``c2w_t0``, the head
    over the torso."""
    data, dirs = scene
    cfg = base_cfg(data, work_dir=dirs["torso"], head_model_dir=dirs["head"], use_color=True)
    infer = LM3dNeRFInfer(cfg, device="cpu")
    assert infer.torso
    conds = infer.get_conds(pred_lm3d(data, 5))
    got = infer.render_frame(3, conds)
    head = LM3dNeRFInfer(base_cfg(data, work_dir=dirs["head"]), device="cpu")
    assert np.abs(got - head.render_frame(3, conds)).max() > 1e-3  # the torso shows
    close(got, _jax_torso_frame(JInfer(JConfig(cfg)), 3, conds))


def test_jax_torso_frame_fault(scene):
    """The JAX renderer's head+torso frame fails: it slices the pose as
    ``eulers[i : i + 1]`` (``[1, 3]``), which ``ADNeRFTorso.cal_cond_feat``
    cannot broadcast (ROADMAP Queue 3). The port passes ``[3]``."""
    data, dirs = scene
    cfg = base_cfg(data, work_dir=dirs["torso"], head_model_dir=dirs["head"], use_color=True)
    jinfer = eager(JInfer(JConfig(cfg)))
    with pytest.raises(ValueError, match="broadcast"):
        jinfer.render_frame(0, jinfer.dataset.conds)


def test_adnerf_frames_and_mp4(scene, tmp_path):
    """ADNeRF from a seeded ``[T, 16, 29]`` DeepSpeech ``.npy``: a frame held
    to JAX's, and ``run`` writes the mp4."""
    data, dirs = scene
    cfg = base_cfg(data, work_dir=dirs["adnerf"], cond_type="deepspeech", smo_win_size=8)
    npy = str(tmp_path / "ds.npy")
    np.save(npy, np.random.RandomState(4).randn(3, 16, 29).astype(np.float32))
    infer = ADNeRFInfer(cfg, device="cpu")
    conds = infer.get_conds(np.load(npy))
    close(infer.render_frame(1, conds), eager(JADInfer(JConfig(cfg))).render_frame(1, conds))
    out = infer.run(npy, str(tmp_path / "out" / "ad.mp4"), n_frames=2)
    assert os.path.getsize(out) > 0


def test_lm3d_mp4_and_scale(scene, tmp_path):
    """``run`` of a predicted lm3d ``.npy`` to an mp4 (head+torso), and a
    head frame at ``infer_scale_factor`` 0.5 held to JAX's."""
    data, dirs = scene
    npy = str(tmp_path / "pred.npy")
    np.save(npy, pred_lm3d(data, 3).reshape(1, 3, 204))
    cfg = base_cfg(data, work_dir=dirs["torso"], head_model_dir=dirs["head"], use_color=True)
    out = LM3dNeRFInfer(cfg, device="cpu").run(npy, str(tmp_path / "out" / "t.mp4"))
    assert os.path.getsize(out) > 0
    cfg = base_cfg(data, work_dir=dirs["head"], infer_scale_factor=0.5)
    infer = LM3dNeRFInfer(cfg, device="cpu")
    conds = infer.get_conds(np.load(npy))
    got = infer.render_frame(0, conds)
    assert got.shape == (16, 16, 3)
    close(got, eager(JInfer(JConfig(cfg))).render_frame(0, conds))
