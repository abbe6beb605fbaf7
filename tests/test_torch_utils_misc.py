"""The port's utilities — the worker pool, the landmark drawing and video,
t-SNE and the 3DMM landmark helper — against the JAX package's on the CPU.

Tolerances: the pool's results and order, the landmark frame, the
landmark edits and the BFM reconstruction are exact (the same numpy code).
The t-SNE descent runs in float64 torch against float64 numpy: the same
operations, but the products sum in another order, and the descent
(learning rate 200, early exaggeration 12) amplifies that: measured on this
input, equal for the first 10 iterations, 3.9e-5 apart after 20 and
unrelated layouts after 40. So the embedding is held to the JAX one to
1e-9 of its magnitude after 10 iterations, and after 260 both separate
the two clusters.
"""

import os
import sys

import numpy as np
import pytest
import torch
from scipy.io import savemat

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from geneface_tpu.utils import face3d as jface3d  # noqa: E402
from geneface_tpu.utils import visualization as jvis  # noqa: E402
from geneface_tpu_torch.utils import (  # noqa: E402
    MultiprocessManager,
    multiprocess_run,
    multiprocess_run_tqdm,
)
from geneface_tpu_torch.utils import face3d, visualization  # noqa: E402

torch.set_num_threads(1)


def _square(x):
    return x * x


def _add(a, b):
    return a + b


def _scaled(x, ctx=None):
    return x * ctx


@pytest.mark.parametrize("multithread", [False, True], ids=["processes", "threads"])
def test_multiprocess_run_order(multithread):
    results = list(multiprocess_run(_square, range(20), num_workers=4, multithread=multithread))
    assert results == [(i, i * i) for i in range(20)]
    unordered = list(multiprocess_run(_square, range(12), num_workers=3, ordered=False,
                                      multithread=multithread))
    assert sorted(unordered) == [(i, i * i) for i in range(12)]
    # dict and tuple arguments, and a per-worker context
    assert [r for _, r in multiprocess_run(_add, [{"a": 1, "b": 2}, (3, 4)], num_workers=2,
                                           multithread=multithread)] == [3, 7]
    assert [r for _, r in multiprocess_run(_scaled, range(4), num_workers=2,
                                           init_ctx_func=lambda w: 10,
                                           multithread=multithread)] == [0, 10, 20, 30]
    assert list(multiprocess_run_tqdm(_square, list(range(5)), num_workers=2,
                                      multithread=True)) == [(i, i * i) for i in range(5)]


def test_multiprocess_manager_threads():
    mgr = MultiprocessManager(num_workers=2, multithread=True)
    for i in range(5):
        mgr.add_job(_add, (i, 10))
    assert len(mgr) == 5
    assert dict(mgr.get_results()) == {i: i + 10 for i in range(5)}


def test_landmark_frame_and_video_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    lm = rng.uniform(-20, 530, (68, 2))  # some off the canvas
    for kw in ({}, {"radius": 1, "draw_lines": False}):
        img = visualization.draw_landmark_frame(lm, wh=512, **kw)
        assert img.dtype == np.uint8 and (img != 255).any()
        np.testing.assert_array_equal(img, jvis.draw_landmark_frame(lm, wh=512, **kw))
    assert visualization.LM68_LINES == jvis.LM68_LINES
    lm3d = rng.uniform(-0.8, 0.8, (4, 68, 3)).astype(np.float32)
    out = visualization.render_lm3d_to_video(lm3d, str(tmp_path / "v" / "lm.mp4"), wh=128)
    assert os.path.getsize(out) > 0
    import cv2

    cap = cv2.VideoCapture(out)
    n = 0
    while cap.read()[0]:
        n += 1
    assert n == 4


def test_tsne_matches_jax():
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.normal(0, 0.05, (40, 8)), rng.normal(3, 0.05, (40, 8))])
    want = jvis.tsne(x, perplexity=10, n_iter=10, seed=0)
    got = visualization.tsne(x, perplexity=10, n_iter=10, seed=0, device="cpu")
    assert got.dtype == np.float32 and got.shape == (80, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())
    emb = visualization.tsne(x, perplexity=10, n_iter=260, seed=0, device="cpu")
    for e in (emb, jvis.tsne(x, perplexity=10, n_iter=260, seed=0)):
        intra = max(e[:40].std(), e[40:].std())
        assert np.linalg.norm(e[:40].mean(0) - e[40:].mean(0)) > 2 * intra


def test_plot_tsne_png(tmp_path):
    x = np.random.RandomState(1).normal(size=(30, 5))
    out = str(tmp_path / "t.png")
    emb = visualization.plot_tsne(x, labels=np.arange(30) % 3, out_png=out, perplexity=5,
                                  n_iter=60, device="cpu")
    assert emb.shape == (30, 2) and os.path.getsize(out) > 0
    assert visualization.plot_tsne(x, perplexity=5, n_iter=5, device="cpu").shape == (30, 2)


def test_face3d_edits_and_reconstruction_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    lm = rng.randn(5, 68, 3).astype(np.float32)
    for a, b in zip(face3d.get_eye_mouth_lm_from_lm3d(lm), jface3d.get_eye_mouth_lm_from_lm3d(lm)):
        np.testing.assert_array_equal(a, b)
    for freeze in (True, False):
        np.testing.assert_array_equal(face3d.close_mouth(lm, freeze),
                                      jface3d.close_mouth(lm, freeze))
    np.testing.assert_array_equal(face3d.close_eyes(lm), jface3d.close_eyes(lm))
    helper = face3d.Face3DHelper(str(tmp_path / "none"))
    coeff = rng.randn(3, 257).astype(np.float32)
    parts = helper.split_coeff(coeff)
    assert {k: v.shape for k, v in parts.items()} == {
        k: v.shape for k, v in jface3d.Face3DHelper().split_coeff(coeff).items()}
    with pytest.raises(FileNotFoundError, match="BFM"):
        helper.reconstruct_idexp_lm3d(parts["identity"], parts["expression"])
    # a BFM-shaped .mat (random bases at reduced vertex count)
    n_v = 100
    bfm = str(tmp_path / "bfm")
    os.makedirs(bfm)
    savemat(os.path.join(bfm, "BFM_model_front.mat"), {
        "meanshape": rng.randn(1, 3 * n_v), "idBase": rng.randn(3 * n_v, 80),
        "exBase": rng.randn(3 * n_v, 64), "keypoints": rng.choice(n_v, 68, False)[None] + 1})
    ours, theirs = face3d.Face3DHelper(bfm), jface3d.Face3DHelper(bfm)
    args = (parts["identity"], parts["expression"])
    np.testing.assert_array_equal(ours.reconstruct_idexp_lm3d(*args),
                                  theirs.reconstruct_idexp_lm3d(*args))
    np.testing.assert_array_equal(ours.reconstruct_lm3d(*args), theirs.reconstruct_lm3d(*args))
    assert ours.reconstruct_lm3d(*args).shape == (3, 68, 3)
