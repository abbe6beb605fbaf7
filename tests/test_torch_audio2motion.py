"""The port's Audio2Motion VAE and its flow prior against the JAX package on
the CPU: ``WN``, the ``ResidualCouplingBlock`` both ways, the posterior
encoder, and ``VAEModel``/``PitchContourVAEModel`` inference at full width
(hidden 256, latent 16, 8/4 WN layers, gin 64/96, the 4-block flow) with
``ln`` and ``bn``.

Every leaf is perturbed from the flax init, so the couplings' output convs
(zero in flax's init, which makes the flow the identity) are non-zero. The
port gets the JAX prior noise: ``jax.random.normal(key, (B, T_sqz, 16))``.
Tolerance: float32 both sides, sums in another order: 1e-4 absolute and
relative at the small sizes; at full width (the condition encoder sums
3 × 1024 terms, the outputs reach ~15) 1e-4 of the output's largest
magnitude. The port's reverse∘forward flow returns its input to 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from geneface_tpu.models.audio2motion import PitchContourVAEModel as JPitchVAE
from geneface_tpu.models.audio2motion import VAEModel as JVAE
from geneface_tpu.models.audio2motion.flow import WN as JWN
from geneface_tpu.models.audio2motion.flow import ResidualCouplingBlock as JBlock
from geneface_tpu.models.audio2motion.vae import FVAEEncoder as JEncoder
from geneface_tpu.utils.pitch import f0_to_coarse as jf0_to_coarse
from geneface_tpu_torch.convert import load_flax_variables
from geneface_tpu_torch.models.audio2motion.flow import WN, ResidualCouplingBlock
from geneface_tpu_torch.models.audio2motion.vae import (
    FVAEEncoder,
    PitchContourVAEModel,
    VAEModel,
)
from geneface_tpu_torch.utils.pitch import coarse_to_f0, f0_to_coarse

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def perturbed(variables, seed=0, scale=0.1):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + scale * rng.randn(*np.shape(x)).astype(np.float32),
        variables)


def cf(x):
    """channel-last numpy → channel-first torch."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 2, 1)))


def cl(t):
    return t.detach().numpy().transpose(0, 2, 1)


def test_pitch_bins_match_jax():
    f0 = np.concatenate([[0.0, -5.0, 49.0, 50.0, 1100.0, 2000.0],
                         np.linspace(40, 1200, 4001)]).astype(np.float32)
    np.testing.assert_array_equal(f0_to_coarse(f0).numpy(), np.asarray(jf0_to_coarse(f0)))
    coarse = np.arange(1, 256)
    back = coarse_to_f0(torch.from_numpy(coarse)).numpy()
    assert back[0] == 0.0 and np.all(np.diff(back[1:]) > 0)


def test_wn_matches_jax():
    rng = np.random.RandomState(0)
    x, g = rng.randn(2, 24, 32).astype(np.float32), rng.randn(2, 24, 8).astype(np.float32)
    mask = np.ones((2, 24, 1), np.float32)
    mask[1, 17:] = 0
    jm = JWN(32, kernel_size=5, dilation_rate=2, n_layers=3, gin_channels=8)
    v = perturbed(jm.init(jax.random.PRNGKey(0), x, mask, g))
    ref = np.asarray(jm.apply(v, x, mask, g))
    m = load_flax_variables(WN(32, 5, 2, 3, gin_channels=8), v)
    with torch.no_grad():
        ours = cl(m(cf(x), cf(mask), cf(g)))
    np.testing.assert_allclose(ours, ref, **TOL)


def test_coupling_block_both_ways_matches_jax():
    rng = np.random.RandomState(1)
    x, g = rng.randn(2, 12, 16).astype(np.float32), rng.randn(2, 12, 64).astype(np.float32)
    mask = np.ones((2, 12, 1), np.float32)
    mask[0, 9:] = 0
    jm = JBlock(16, 64, 3, 1, 4, 4, gin_channels=64)
    v = jm.init(jax.random.PRNGKey(0), x, mask, g)
    zero_out = v["params"]["couplings_0"]["Conv_0"]["kernel"]
    assert not np.any(np.asarray(zero_out))  # flax's init: the identity flow
    v = perturbed(v, seed=2)
    m = load_flax_variables(ResidualCouplingBlock(16, 64, 3, 1, 4, 4, gin_channels=64), v)
    with torch.no_grad():
        for reverse in (False, True):
            ref = np.asarray(jm.apply(v, x, mask, g, reverse=reverse))
            ours = cl(m(cf(x), cf(mask), cf(g), reverse=reverse))
            np.testing.assert_allclose(ours, ref, **TOL)
            assert np.abs(ref - x * mask).max() > 0.1  # the flow does move x
        xm = cf(x * mask)
        back = m(m(xm, cf(mask), cf(g)), cf(mask), cf(g), reverse=True)
    np.testing.assert_allclose(back.numpy(), xm.numpy(), atol=1e-5)


def test_posterior_encoder_matches_jax():
    rng = np.random.RandomState(3)
    x, g = rng.randn(1, 20, 24).astype(np.float32), rng.randn(1, 5, 8).astype(np.float32)
    mask = np.ones((1, 20, 1), np.float32)
    jm = JEncoder(32, 4, 5, 2, gin_channels=8, strides=(4,))
    key = jax.random.PRNGKey(7)
    v = perturbed(jm.init(jax.random.PRNGKey(0), x, mask, g, key))
    z, mu, logs, msq = (np.asarray(a) for a in jm.apply(v, x, mask, g, key))
    noise = np.array(jax.random.normal(key, mu.shape))
    m = load_flax_variables(FVAEEncoder(24, 32, 4, 5, 2, gin_channels=8), v)
    with torch.no_grad():
        ours = m(cf(x), cf(mask), cf(g), cf(noise))
    for a, b in zip(ours, (z, mu, logs, msq)):
        np.testing.assert_allclose(cl(a), b, **TOL)


@pytest.mark.parametrize("norm", ["ln", "bn"])
@pytest.mark.parametrize("pitch", [False, True], ids=["vae", "pitch_vae"])
def test_vae_inference_matches_jax(pitch, norm):
    """Full width; 56 HuBERT rows → 28 frames → 7 latent frames: the
    strided pre-nets' (2, 2) padding reaches both ends."""
    rng = np.random.RandomState(4)
    T2 = 56
    hubert = rng.randn(1, T2, 1024).astype(np.float32)
    f0 = np.where(rng.rand(1, T2) < 0.3, 0.0, rng.uniform(80, 400, (1, T2))).astype(np.float32)
    batch = {"hubert": hubert, "y_mask": np.ones((1, T2 // 2), np.float32),
             "f0": f0, "y": rng.randn(1, T2 // 2, 204).astype(np.float32)}
    jcls, cls = (JPitchVAE, PitchContourVAEModel) if pitch else (JVAE, VAEModel)
    jm = jcls(in_out_dim=204, norm=norm)
    v = perturbed(jm.init(jax.random.PRNGKey(0), batch, jax.random.PRNGKey(1), train=True))
    key, temperature = jax.random.PRNGKey(5), 0.7
    ref = jm.apply(v, batch, key, train=False, temperature=temperature)
    m = load_flax_variables(cls(in_out_dim=204, norm=norm), v)
    assert m.noise_shape(1, T2 // 2) == (1, 7, 16)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (1, 7, 16))))
    tb = {k: torch.from_numpy(a) for k, a in batch.items() if k != "y"}
    with torch.no_grad():
        out = m(tb, noise, temperature=temperature)
    assert out["pred"].shape == (1, T2 // 2, 204)
    for k in ("z_p", "pred"):
        want = np.asarray(ref[k])
        np.testing.assert_allclose(out[k].numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    # the training branch runs on the landmarks (held to JAX in
    # tests/test_torch_vae_train.py)
    with torch.no_grad():
        trained = m({k: torch.from_numpy(a) for k, a in batch.items()}, noise, train=True)
    assert trained["pred"].shape == (1, T2 // 2, 204)
    assert bool(torch.isfinite(trained["loss_kl"]))
