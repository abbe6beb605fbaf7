"""The port's post-net and LLE projection against the JAX package on the
CPU.

Post-net: ``CNNPostNet`` and ``PitchContourCNNPostNet`` at full width
(204 landmark channels, the 128/256 conv stack), ``ln`` and ``bn``, with
all-zero (padding) frames that must stay unchanged; every leaf perturbed
from the flax init. Tolerance: 1e-4 of the output's largest magnitude
(float32 sums of up to 3 × 268 terms per layer, seven layers).

LLE: ``torch.topk`` and ``jax.lax.top_k`` may order equal distances
differently, and pick another of several equal rows, so the neighbours'
rows (as sets) and the fused rows are held, not the indices' order
or the weights'. Fused rows to 1e-4 absolute (float32 solves of
``K - 1`` unknowns on differences of O(1) rows); duplicate database rows
(a singular Gram matrix without the trace-scaled ridge) and ``K == 1``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneface_tpu.inference.landmark_postprocess import lle_project_lm3d as jlle_project
from geneface_tpu.models.postnet import CNNPostNet as JPostNet
from geneface_tpu.models.postnet import PitchContourCNNPostNet as JPitchPostNet
from geneface_tpu.models.postnet import lle as jlle
from geneface_tpu_torch.convert import load_flax_variables
from geneface_tpu_torch.inference.landmark_postprocess import lle_project_lm3d
from geneface_tpu_torch.models.postnet import lle
from geneface_tpu_torch.models.postnet.models import CNNPostNet, PitchContourCNNPostNet

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)


def perturbed(variables, seed=0, scale=0.1):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + scale * rng.randn(*np.shape(x)).astype(np.float32),
        variables)


@pytest.mark.parametrize("norm", ["ln", "bn"])
@pytest.mark.parametrize("pitch", [False, True], ids=["postnet", "pitch_postnet"])
def test_postnet_matches_jax(pitch, norm):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 24, 204).astype(np.float32)
    x[1, 17:] = 0.0  # padding frames
    p = rng.randn(2, 24, 64).astype(np.float32)
    if pitch:
        jm, m = JPitchPostNet(204, 64, norm), PitchContourCNNPostNet(204, 64, norm)
        args = (x, p)
    else:
        jm, m = JPostNet(204, norm), CNNPostNet(204, norm)
        args = (x,)
    v = perturbed(jm.init(jax.random.PRNGKey(0), *args))
    ref = np.asarray(jm.apply(v, *args))
    load_flax_variables(m, v)
    with torch.no_grad():
        ours = m(*[torch.from_numpy(a) for a in args]).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    np.testing.assert_array_equal(ours[1, 17:], 0.0)  # masked frames stay
    assert np.abs(ours[0] - x[0]).max() > 0.1  # the delta is not zero


def _database(rng, n=40, c=12):
    db = rng.randn(n, c).astype(np.float32)
    db[5] = db[6] = db[7]  # duplicate rows: singular without the ridge
    return db


@pytest.mark.parametrize("K", [1, 4, 10])
def test_lle_matches_jax(K):
    rng = np.random.RandomState(1)
    db = _database(rng)
    feats = (db[rng.randint(0, len(db), 16)] + 0.3 * rng.randn(16, 12)).astype(np.float32)
    feats[0] = db[7] + 1e-3  # neighbours 5, 6, 7 tie
    jidx = np.asarray(jlle.find_k_nearest_neighbors(jnp.asarray(feats), jnp.asarray(db), K))
    idx = lle.find_k_nearest_neighbors(torch.from_numpy(feats), torch.from_numpy(db), K).numpy()
    for r in range(len(feats)):  # the same neighbour rows, in any order
        np.testing.assert_array_equal(np.unique(db[idx[r]], axis=0), np.unique(db[jidx[r]], axis=0))
    jfused, _ = jlle.compute_lle_projection(jnp.asarray(feats), jnp.asarray(db), K)
    fused, w = lle.compute_lle_projection(torch.from_numpy(feats), torch.from_numpy(db), K)
    assert torch.isfinite(fused).all() and w.shape == (16, K)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(fused.numpy(), np.asarray(jfused), atol=1e-4)
    if K == 1:
        np.testing.assert_array_equal(fused.numpy(), db[idx[:, 0]])


def test_solve_lle_projection_with_duplicate_neighbours():
    rng = np.random.RandomState(2)
    base = rng.randn(3, 5, 8).astype(np.float32)
    base[:, 2] = base[:, 3] = base[:, 1]  # three equal neighbours per row
    feat = (base.mean(1) + 0.1 * rng.randn(3, 8)).astype(np.float32)
    jfused, _ = jlle.solve_lle_projection(jnp.asarray(feat), jnp.asarray(base))
    fused, w = lle.solve_lle_projection(torch.from_numpy(feat), torch.from_numpy(base))
    assert torch.isfinite(w).all()
    np.testing.assert_allclose(fused.numpy(), np.asarray(jfused), atol=1e-4)


def test_lle_solve_is_float64_on_rank_deficient_database():
    """A database of rank 2 (landmarks driven by one signal, as a short
    video's) and queries off it: the Gram matrix is singular but for its
    ridge, so float32 rounding of its products moves the fused rows well
    past 1e-6 of their magnitude (a float32 solve fails this test); the port
    solves in float64 and returns float32 rows within 1e-6 of a float64
    evaluation."""
    rng = np.random.RandomState(2)
    basis = rng.randn(2, 204)
    db = (rng.randn(12, 2) @ basis).astype(np.float32)
    db += 1e-5 * rng.randn(*db.shape).astype(np.float32)
    feats = (db[:6] + 2.0 * rng.randn(6, 204)).astype(np.float32)  # off the manifold
    idx = lle.find_k_nearest_neighbors(torch.from_numpy(feats), torch.from_numpy(db), 10)
    base = torch.from_numpy(db)[idx]
    fused, w = lle.solve_lle_projection(torch.from_numpy(feats), base)
    ref, _ = lle.solve_lle_projection(torch.from_numpy(feats).double(), base.double())
    assert fused.dtype == w.dtype == torch.float32
    ref = ref.numpy()
    np.testing.assert_allclose(fused.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    # the JAX package solves in float32: its rows lie ~4e-5 from the float64
    # ones here (ROADMAP's oracle list), inside the 1e-4 the port-vs-JAX
    # tests allow
    jfused, _ = jlle.solve_lle_projection(jnp.asarray(feats), jnp.asarray(base.numpy()))
    np.testing.assert_allclose(np.asarray(jfused), ref, rtol=0, atol=1e-4)


def test_lle_project_lm3d_matches_jax():
    rng = np.random.RandomState(3)
    db = rng.randn(30, 68, 3).astype(np.float32)
    lm = (db[:9] + 0.2 * rng.randn(9, 68, 3)).astype(np.float32)
    for percent in (0.0, 0.4, 1.0):
        ref = jlle_project(lm, db, percent)
        ours = lle_project_lm3d(lm, db, percent, device="cpu")
        assert ours.shape == lm.shape
        np.testing.assert_allclose(ours, ref, atol=1e-4)
    np.testing.assert_array_equal(lle_project_lm3d(lm, db, 0.0, device="cpu"), lm)
