"""The port's numpy copies on the vanilla NeRF path against the JAX
package's, exactly: the ray samplers from the same ``RandomState``, the
dataset's head and torso items and their epoch order (the condition types
lm3d, DeepSpeech and esperanto), the pose condition
(``c2w_to_euler_trans``), and the landmark edits of ``LM3dNeRFInfer``
(periodic and ground-truth blinks, the closed mouth on silence). Every
comparison is bit for bit.
"""

import os
import sys

import numpy as np
import pytest
import torch

from geneface_tpu.data import ray_samplers as jrs
from geneface_tpu.data.nerf_dataset import NeRFDataset as JDataset
from geneface_tpu.inference import landmark_postprocess as jlp
from geneface_tpu.utils.camera import c2w_to_euler_trans as j_c2w_to_euler_trans
from geneface_tpu_torch.data import ray_samplers as trs
from geneface_tpu_torch.data.nerf_dataset import NeRFDataset
from geneface_tpu_torch.inference import landmark_postprocess as tlp
from geneface_tpu_torch.utils.camera import c2w_to_euler_trans

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.make_synthetic_dataset import make_dataset  # noqa: E402

torch.set_num_threads(1)


def same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("nerf_data"))
    make_dataset(d, n_frames=6, hw=32)
    return d


def _pose(rng):
    c2w = np.eye(4, dtype=np.float32)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    c2w[:3, :3] = q
    c2w[:3, 3] = rng.randn(3)
    return c2w


@pytest.mark.parametrize("kind", ["uniform", "uniform_rect", "torso", "full", "patch",
                                  "patch_rect"])
def test_samplers_match_jax(kind):
    c2w = _pose(np.random.RandomState(0))
    H, W, focal = 40, 48, 60.0
    make = {
        "uniform": lambda m, r: m.UniformRaySampler(rng=r)(H, W, focal, c2w, n_rays=64),
        "uniform_rect": lambda m, r: m.UniformRaySampler(rng=r)(
            H, W, focal, c2w, n_rays=64, rect=(10, 8, 20, 16), in_rect_percent=0.9, cx=23.5),
        "torso": lambda m, r: m.TorsoUniformRaySampler(rng=r)(H, W, focal, c2w, n_rays=50),
        "full": lambda m, r: m.FullRaySampler(0.5)(H, W, focal, c2w, cx=20.0, cy=19.0),
        "patch": lambda m, r: m.PatchRaySampler(64, rng=r)(H, W, focal, c2w),
        "patch_rect": lambda m, r: m.PatchRaySampler(64, rng=r)(H, W, focal, c2w,
                                                                rect=(10, 8, 20, 16)),
    }[kind]
    same(make(trs, np.random.RandomState(3)), make(jrs, np.random.RandomState(3)))


def test_rays_and_pixel_helpers_match_jax():
    rng = np.random.RandomState(1)
    c2w = _pose(rng)
    same(trs.get_rays_nerf(12, 16, 20.0, c2w, cx=7.5), jrs.get_rays_nerf(12, 16, 20.0, c2w,
                                                                        cx=7.5))
    img = rng.rand(12, 16, 3).astype(np.float32)
    coords = np.stack([rng.randint(0, 12, 30), rng.randint(0, 16, 30)], -1)
    same(trs.sample_pixels(img, coords), jrs.sample_pixels(img, coords))
    grid = rng.uniform(-1, 1, (5, 5, 2)).astype(np.float32)
    same(trs.bilinear_sample_image(img, grid), jrs.bilinear_sample_image(img, grid))


def test_pose_condition_matches_jax():
    rng = np.random.RandomState(2)
    c2w = np.stack([_pose(rng) for _ in range(5)])
    same(c2w_to_euler_trans(c2w), j_c2w_to_euler_trans(c2w))


def _cfg(**over):
    cfg = dict(cond_type="idexp_lm3d_normalized", cond_win_size=1, smo_win_size=3, n_rays=48,
               in_rect_percent=0.9, near=0.3, far=0.9, seed=4, infer_scale_factor=1.0)
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("cond_type, smo", [("idexp_lm3d_normalized", 3), ("deepspeech", 8),
                                             ("esperanto", 8)])
def test_dataset_items_match_jax(synth, cond_type, smo):
    """Head and torso items interleaved from the shared ``RandomState``,
    the epoch order, and a full-frame item."""
    cfg = _cfg(cond_type=cond_type, smo_win_size=smo)
    t, j = NeRFDataset("train", synth, cfg), JDataset("train", synth, cfg)
    same(t.conds, j.conds)
    same((t.eulers, t.transs, t.c2w_t0), (j.eulers, j.transs, j.c2w_t0))
    for i in (0, 2, 1):
        same(t[i], j[i])
        same(t.get_torso_item(i), j.get_torso_item(i))
    ti, ji = t.iter_epochs(), j.iter_epochs()
    for _ in range(len(t) + 2):
        same(next(ti), next(ji))
    ti, ji = t.iter_torso_epochs(), j.iter_torso_epochs()
    for _ in range(3):
        same(next(ti), next(ji))
    full = _cfg(cond_type=cond_type, smo_win_size=smo, infer_scale_factor=0.5)
    t, j = NeRFDataset("trainval", synth, full, training=False), JDataset(
        "trainval", synth, full, training=False)
    same(t[len(t) - 1], j[len(j) - 1])
    same(t.get_torso_item(1), j.get_torso_item(1))


def test_blink_and_silence_edits_match_jax():
    rng = np.random.RandomState(5)
    lm = rng.randn(300, 68, 3).astype(np.float32)
    db = rng.randn(40, 68, 3).astype(np.float32)
    same(tlp.inject_blinks(lm, db[0], period_s=2.0), jlp.inject_blinks(lm, db[0], period_s=2.0))
    for mode, kw in (("none", {}), ("gt", {}), ("period", dict(ref_start=5, ref_end=11))):
        same(tlp.inject_blinks_from_gt(lm, db, mode=mode, **kw),
             jlp.inject_blinks_from_gt(lm, db, mode=mode, **kw))
    with pytest.raises(ValueError):
        tlp.inject_blinks_from_gt(lm, db, mode="period")
    mel = rng.randn(2 * len(lm) - 3, 80).astype(np.float32) * 3.0 - 3.0
    same(tlp.close_mouth_when_silent(lm, mel, db[1]),
         jlp.close_mouth_when_silent(lm, mel, db[1]))
    assert not np.array_equal(tlp.close_mouth_when_silent(lm, mel, db[1]), lm)
