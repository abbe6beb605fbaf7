"""The port's datagen path (``geneface_tpu_torch/datagen/{process,binarizer}``,
the camera and mel helpers, ``extract_3dmm_coeffs``) against the JAX
package's on the CPU.

End to end: ``process_video`` then ``binarize_video`` on both sides, on the
8-frame 64² video of ``tests/test_datagen.py::_make_test_video`` with its
stand-in ``parse_fn``/``lm_fn``, a 20×20 sphere-cap basis (``lm_index`` its
68 landmark vertices) and photometric refinement. The landmark fit runs at
its defaults (11 focals × 300 steps, 700 joint steps). The refinement runs
5 global and 5 per-frame steps on both sides (not its defaults, 150 and
80): the soft splat's coverage mask ``weight > 0.05`` and Adam's
normalization of gradients near zero make its trajectory chaotic: a
last-bit difference grows into parts of the learning rate within tens of
steps on this scene. ``tests/test_torch_face_tracker.py`` holds every step
of the refinement instead. The stores are compared key by
key: images, landmarks, rects, mel and f0 exact, the same focal; ``c2w``
within 1e-4 of max |ref| (measured 2.4e-5) and the normalized idexp
conditions within 2e-3 (measured 3.2e-4: the normalization divides by the
spread over 8 frames).
"""

import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_datagen import _make_test_video
from torch_datagen_helpers import (
    jax_full_basis,
    jax_lm_basis,
    max_rel,
    sphere_cap,
    torch_full_basis,
    torch_lm_basis,
)

import geneface_tpu.datagen.face_tracker as JT
import geneface_tpu_torch.datagen.face_tracker as PT
from geneface_tpu.datagen import binarizer as JB
from geneface_tpu.datagen import process as JPR
from geneface_tpu.utils import audio as JA
from geneface_tpu.utils import camera as JC
from geneface_tpu_torch.datagen import binarizer as PB
from geneface_tpu_torch.datagen import process as PPR
from geneface_tpu_torch.utils import audio as PA
from geneface_tpu_torch.utils import camera as PC

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)

PHOTO_STEPS = dict(global_steps=5, frame_steps=5)


def parse_fn(frame):
    """The JAX test's stand-in parser: the bright circle is the head, the
    bottom rows the torso."""
    mask = np.zeros(frame.shape[:2], int)
    mask[frame[..., 0] > 100] = 1
    mask[-8:] = 3
    return mask


def lm_fn(frame):
    """The JAX test's stand-in landmarks: 68 points on a circle around the
    head."""
    ys, xs = np.where(frame[..., 0] > 100)
    cy, cx = (ys.mean(), xs.mean()) if len(ys) else (32, 32)
    th = np.linspace(0, 2 * np.pi, 68, endpoint=False)
    return np.stack([cx + 10 * np.cos(th), cy + 10 * np.sin(th)], -1).astype(np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("datagen")
    video, wav = _make_test_video(str(tmp / "vid.mp4"))
    b = sphere_cap(np.random.RandomState(0))
    mp = pytest.MonkeyPatch()
    mp.setattr(JT, "refine_photometric", functools.partial(JT.refine_photometric, **PHOTO_STEPS))
    mp.setattr(PT, "refine_photometric", functools.partial(PT.refine_photometric, **PHOTO_STEPS))
    try:
        jm = JPR.process_video(video, str(tmp / "jproc"), parse_fn=parse_fn, lm_fn=lm_fn,
                               basis=jax_lm_basis(b), full_basis=jax_full_basis(b),
                               max_frames=8, wav_path=wav)
        pm = PPR.process_video(video, str(tmp / "pproc"), parse_fn=parse_fn, lm_fn=lm_fn,
                               basis=torch_lm_basis(b), full_basis=torch_full_basis(b),
                               max_frames=8, wav_path=wav, device="cpu")
    finally:
        mp.undo()
    jstore = JB.binarize_video(jm, str(tmp / "jbin"), basis=jax_lm_basis(b))
    pstore = PB.binarize_video(pm, str(tmp / "pbin"), basis=torch_lm_basis(b))
    return {"tmp": tmp, "b": b, "jm": jm, "pm": pm,
            "J": np.load(jstore, allow_pickle=True).item(),
            "P": np.load(pstore, allow_pickle=True).item(), "pdir": str(tmp / "pbin")}


def test_manifest_matches_jax(runs):
    jm, pm = runs["jm"], runs["pm"]
    assert pm["frames"].shape == (8, 64, 64, 3)
    for k in ("frames", "masks", "bg_img", "lms"):
        np.testing.assert_array_equal(pm[k], jm[k], err_msg=k)
    assert pm["face_rects"] == jm["face_rects"]
    for k in ("mel", "f0"):
        np.testing.assert_array_equal(pm["audio"][k], jm["audio"][k], err_msg=k)
    assert pm["audio"]["hubert"] is None and jm["audio"]["hubert"] is None  # no checkpoint
    for s, r in zip(pm["splits"], jm["splits"]):
        for k in ("gt_img", "head_img", "torso_img"):
            np.testing.assert_array_equal(s[k], r[k], err_msg=k)
    pt, jt = pm["track"], jm["track"]
    assert pt["focal"] == jt["focal"]
    for k in ("euler", "trans", "id", "exp", "tex"):
        assert max_rel(pt[k], jt[k]) <= 2e-4, k  # measured ≤ 4.2e-5
    assert max_rel(pt["light"], jt["light"]) <= 4e-3  # measured 8.1e-4
    assert abs(pt["photo_loss"] - jt["photo_loss"]) <= 1e-3 * abs(jt["photo_loss"])


def test_transforms_match_jax(runs):
    for split in ("train", "val"):
        names = [os.path.join(runs["tmp"], d, f"transforms_{split}.json") for d in ("pproc", "jproc")]
        got, ref = (json.load(open(n)) for n in names)
        assert got["focal_len"] == ref["focal_len"] and (got["cx"], got["cy"]) == (ref["cx"], ref["cy"])
        assert [f["img_id"] for f in got["frames"]] == [f["img_id"] for f in ref["frames"]]
        assert [f["face_rect"] for f in got["frames"]] == [f["face_rect"] for f in ref["frames"]]
        m_got = np.array([f["transform_matrix"] for f in got["frames"]])
        m_ref = np.array([f["transform_matrix"] for f in ref["frames"]])
        assert max_rel(m_got, m_ref) <= 1e-4


def test_stores_match_key_by_key(runs):
    J, P = runs["J"], runs["P"]
    assert sorted(P) == sorted(J)
    for k in ("H", "W", "focal", "cx", "cy"):
        assert P[k] == J[k], k
    for k in ("bg_img", "mel", "f0"):
        np.testing.assert_array_equal(P[k], J[k], err_msg=k)
    for k in ("idexp_lm3d_mean", "idexp_lm3d_std"):
        assert max_rel(P[k], J[k]) <= 1e-4, k
    for split in ("train_samples", "val_samples"):
        assert len(P[split]) == len(J[split]) > 0
        for s, r in zip(P[split], J[split]):
            assert sorted(s) == sorted(r)
            for k in ("idx", "face_rect"):
                assert s[k] == r[k]
            for k in ("gt_img", "head_img", "torso_img", "lms"):
                np.testing.assert_array_equal(s[k], r[k], err_msg=k)
                assert s[k].dtype == r[k].dtype
            assert s["c2w"].dtype == r["c2w"].dtype == np.float32
            assert max_rel(s["c2w"], r["c2w"]) <= 1e-4
            assert max_rel(s["idexp_lm3d_normalized_win"], r["idexp_lm3d_normalized_win"]) <= 2e-3


def test_binarize_of_the_jax_manifest_is_the_jax_store(runs, tmp_path):
    """The binarizer alone, on the JAX package's manifest: the same store."""
    jm = dict(runs["jm"])
    path = PB.binarize_video(jm, str(tmp_path), basis=torch_lm_basis(runs["b"]), cond_win_size=3)
    ref = JB.binarize_video(jm, str(tmp_path / "j"), basis=jax_lm_basis(runs["b"]),
                            cond_win_size=3)
    P, J = (np.load(p, allow_pickle=True).item() for p in (path, ref))
    for split in ("train_samples", "val_samples"):
        for s, r in zip(P[split], J[split]):
            np.testing.assert_allclose(s["c2w"], r["c2w"], rtol=0, atol=1e-6)
            np.testing.assert_allclose(s["idexp_lm3d_normalized_win"],
                                       r["idexp_lm3d_normalized_win"], rtol=1e-5, atol=1e-5)
            assert s["idexp_lm3d_normalized_win"].shape == (3, 204)


def test_port_dataset_loads_the_store(runs):
    from geneface_tpu_torch.data.radnerf_dataset import RADNeRFDataset

    cfg = {"cond_type": "idexp_lm3d_normalized", "cond_win_size": 1, "n_rays": 64}
    ds = RADNeRFDataset("train", runs["pdir"], cfg, training=True)
    assert len(ds.samples) == len(runs["P"]["train_samples"])
    assert ds.conds.shape[-1] == 204 and np.isfinite(np.asarray(ds.conds)).all()
    assert (ds.H, ds.W) == (64, 64) and ds.focal == runs["P"]["focal"]
    val = RADNeRFDataset("val", runs["pdir"], cfg)
    assert len(val.samples) == 1


def test_melspectrogram_matches_jax():
    wav = np.random.RandomState(0).randn(8000).astype(np.float32) * 0.1
    got, ref = PA.melspectrogram(wav), JA.melspectrogram(wav)
    assert got.shape == ref.shape == (51, 80) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_euler_trans_to_c2w_matches_jax():
    rng = np.random.RandomState(1)
    euler, trans = rng.randn(5, 3).astype(np.float32), rng.randn(5, 3).astype(np.float32)
    np.testing.assert_array_equal(PC.euler_trans_to_c2w(euler, trans),
                                  JC.euler_trans_to_c2w(euler, trans))
    # and it inverts convert_poses
    c2w = PC.euler_trans_to_c2w(euler * 0.3, trans)
    np.testing.assert_allclose(PC.convert_poses(c2w), np.concatenate([euler * 0.3, trans], -1),
                               atol=1e-5)


def test_background_and_head_torso_split_match_jax():
    rng = np.random.RandomState(2)
    T, H, W = 4, 32, 32
    frames = rng.randint(0, 255, (T, H, W, 3)).astype(np.uint8)
    masks = rng.randint(0, 4, (T, H, W))
    masks[:, 28:, 28:] = 1  # never background: filled from the nearest seen pixel
    bg = PPR.reconstruct_background(frames, masks)
    np.testing.assert_array_equal(bg, JPR.reconstruct_background(frames, masks))
    got = PPR.split_head_torso(frames[0], masks[0], bg)
    ref = JPR.split_head_torso(frames[0], masks[0], bg)
    for k in ("gt_img", "head_img", "torso_img"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_export_transforms_matches_jax(tmp_path):
    rng = np.random.RandomState(3)
    track = {"euler": rng.randn(12, 3) * 0.1, "trans": rng.randn(12, 3), "focal": 900.0}
    rects = [(i, i + 10, 2 * i, 2 * i + 10) for i in range(12)]
    got = PPR.export_transforms(str(tmp_path / "p"), track, 64, 48, rects)
    ref = JPR.export_transforms(str(tmp_path / "j"), track, 64, 48, rects)
    for g, r in zip(got, ref):
        assert json.load(open(g)) == json.load(open(r))


def test_binarize_lrs3_round_trip(tmp_path):
    """The port's shards read back through the port's and the JAX
    package's ``IndexedDataset``."""
    from geneface_tpu.utils.indexed_dataset import IndexedDataset as JIndexed
    from geneface_tpu_torch.utils.indexed_dataset import IndexedDataset

    rng = np.random.RandomState(4)
    clips = [{"id": f"clip{i}", "mel": rng.randn(40, 80).astype(np.float32),
              "f0": rng.rand(40).astype(np.float32),
              "hubert": rng.randn(40, 16).astype(np.float32),
              "idexp_lm3d": rng.randn(20, 204).astype(np.float32)} for i in range(5)]
    train_p, val_p = PB.binarize_lrs3(clips, str(tmp_path / "lrs3"))
    assert json.load(open(tmp_path / "lrs3" / "meta.json")) == {"n_train": 4, "n_val": 1}
    for reader in (IndexedDataset, JIndexed):
        tr, va = reader(train_p), reader(val_p)
        assert len(tr) == 4 and len(va) == 1
        for got, want in zip(list(tr) + list(va), clips[1:] + clips[:1]):
            assert got["id"] == want["id"]
            for k in ("mel", "f0", "hubert", "idexp_lm3d"):
                np.testing.assert_array_equal(got[k], want[k])


def test_get_win_conds_matches_jax():
    conds = np.arange(30, dtype=np.float32).reshape(10, 3)
    for idx in (0, 4, 9):
        for win in (1, 4, 7):
            np.testing.assert_array_equal(PB.get_win_conds(conds, idx, win),
                                          JB.get_win_conds(conds, idx, win))


def test_extract_3dmm_coeffs_matches_jax():
    """``extract_3dmm_coeffs`` at seeded ReconNet weights on 3 frames in
    batches of 2; coefficients within 1e-5 of max |ref|."""
    from geneface_tpu.datagen import extract_3dmm_coeffs as jax_extract
    from geneface_tpu.datagen.face_recon import Reconstructor as JRecon
    from geneface_tpu_torch.convert import flax_variables
    from geneface_tpu_torch.datagen import extract_3dmm_coeffs
    from geneface_tpu_torch.datagen.face_recon import ReconNet, Reconstructor
    from geneface_tpu_torch.models.layers import init_weights_

    net = init_weights_(ReconNet(), torch.Generator().manual_seed(5)).eval()
    rng = np.random.RandomState(5)
    frames = rng.randint(0, 256, (3, 96, 96, 3)).astype(np.uint8)
    lms = rng.rand(3, 68, 2) * 30 + 33
    got = extract_3dmm_coeffs(frames, lms, Reconstructor(net=net, device="cpu"), batch_size=2)
    ref = jax_extract(frames, lms, JRecon(params=flax_variables(net)), batch_size=2)
    assert got.shape == (3, 257) and got.dtype == np.float32
    assert max_rel(got, ref) <= 1e-5
    assert jnp.isfinite(ref).all()
