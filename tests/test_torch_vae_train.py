"""The VAE's training branch against the JAX package on the CPU:
``VAEModel(204)`` and ``PitchContourVAEModel(204)`` with ``train=True`` at
B = 2, T = 32 (one clip padded), fed JAX's posterior draw
(``jax.random.normal(split(rng)[0], (B, T/4, 16))``), every leaf perturbed
from the flax init (so the flow is not the identity), the posterior's
output convolution then scaled by 0.05: perturbed at full scale it puts
``logs_q`` at up to 16 and ``z_q = m_q + ε·exp(logs_q)`` at 1e7, where
float32 keeps no digit of the reconstruction; scaled, ``|logs_q|`` stays
under ~3, a trained VAE's range. ``pred`` and ``loss_kl`` within 1e-4 of
max |ref| (float32 sums in another order through the ×4 pre-nets, the
8-layer WaveNet and the 4-block flow); every parameter's gradient of
``sum(pred·w) + loss_kl`` within 1e-4 relative L2 of the port's float64
gradient, and of JAX's within 1e-4 plus JAX's own distance from that
float64 gradient (JAX's float32 gradients lie up to 1.2e-4 from it, the
port's 5e-5). With the flow prior (``VAEModel``, also with
``sqz_prior``), and without it (the closed-form KL;
``PitchContourVAEModel``); ``sqz_prior``'s key-projection bias has a zero
gradient in exact arithmetic, held to 1e-6 of the largest gradient on
both sides. The flow run forward then in reverse gives back its input
(1e-5), and its forward direction matches JAX's."""

import jax
import numpy as np
import pytest
import torch

from geneface_tpu.models.audio2motion import PitchContourVAEModel as JPitchVAE
from geneface_tpu.models.audio2motion import VAEModel as JVAE
from geneface_tpu.models.audio2motion.flow import ResidualCouplingBlock as JBlock
from geneface_tpu_torch.convert import flax_param_tree, load_flax_variables
from geneface_tpu_torch.models.audio2motion.flow import ResidualCouplingBlock
from geneface_tpu_torch.models.audio2motion.vae import PitchContourVAEModel, VAEModel
from torch_audio_helpers import flat as _flat
from torch_audio_helpers import perturbed, rel_l2

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)

B, T = 2, 32


def vae_variables(jm, batch, rng):
    v = perturbed(jm.init(jax.random.PRNGKey(0), batch, rng, train=True), seed=1)
    out = v["params"]["vae"]["encoder"]["out"]
    out["kernel"], out["bias"] = 0.05 * out["kernel"], 0.05 * out["bias"]
    return v


def _grads(model, batch, noise, w) -> dict:
    """The flax-layout gradient of ``sum(pred·w) + loss_kl`` in the model's
    dtype."""
    dt = next(model.parameters()).dtype
    model.zero_grad()
    out = model({k: torch.from_numpy(x).to(dt) for k, x in batch.items()},
                torch.from_numpy(noise).to(dt), train=True)
    ((out["pred"] * torch.from_numpy(w).to(dt)).sum() + out["loss_kl"]).backward()
    return _flat(flax_param_tree(model, {n: p.grad for n, p in model.named_parameters()
                                         if p.grad is not None}))


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randn(B, T, 204).astype(np.float32)
    y_mask = np.ones((B, T), np.float32)
    y[1, 23:] = 0.0
    y_mask[1, 23:] = 0.0
    return {"hubert": rng.randn(B, 2 * T, 1024).astype(np.float32), "y": y, "y_mask": y_mask,
            "f0": (120 + 80 * rng.rand(B, 2 * T)).astype(np.float32)}


CASES = {
    "flow": (JVAE, VAEModel, dict(use_prior_flow=True)),
    "sqz_prior": (JVAE, VAEModel, dict(sqz_prior=True)),
    "pitch_no_flow": (JPitchVAE, PitchContourVAEModel, dict(use_prior_flow=False)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_forward_and_gradients_match_jax(case):
    jcls, cls, kw = CASES[case]
    batch = _batch()
    jm = jcls(in_out_dim=204, **kw)
    rng = jax.random.PRNGKey(3)
    v = vae_variables(jm, batch, rng)
    w = np.random.RandomState(2).randn(B, T, 204).astype(np.float32)

    @jax.jit
    def run(p):
        def f(p):
            out = jm.apply(p, batch, rng, train=True)
            return (out["pred"] * w).sum() + out["loss_kl"], out
        return jax.value_and_grad(f, has_aux=True)(p)

    (_, out), grads = run(v)
    T_sqz = np.asarray(out["m_q"]).shape[1]
    noise = np.asarray(jax.random.normal(jax.random.split(rng)[0], (B, T_sqz, 16)))
    model = load_flax_variables(cls(in_out_dim=204, **kw), v)
    assert model.noise_shape(B, T) == noise.shape
    assert np.abs(np.asarray(out["m_q"])).max() < 30
    tb = {k: torch.from_numpy(x) for k, x in batch.items()}
    ours = model(tb, torch.from_numpy(noise), train=True)
    for k in ("pred", "m_q", "z_p"):
        ref = np.asarray(out[k])
        np.testing.assert_allclose(ours[k].detach().numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=k)
    kl = float(out["loss_kl"])
    assert abs(float(ours["loss_kl"]) - kl) <= 1e-4 * abs(kl), (float(ours["loss_kl"]), kl)
    np.testing.assert_array_equal(ours["pred"][1, 23:].detach().numpy(), 0.0)
    got, f64 = ({k: g for k, g in _grads(model.to(dt), batch, noise, w).items()}
                for dt in (torch.float32, torch.float64))
    want = _flat(jax.tree_util.tree_map(np.asarray, grads["params"]))
    want = {("params",) + k: g for k, g in want.items()}
    assert sorted(got) == sorted(want) == sorted(f64)
    # sqz_prior: the key projection's bias shifts every attention logit of
    # a clip alike, so its gradient is zero in exact arithmetic (softmax is
    # shift-invariant) and both sides hold only rounding: held to 1e-6 of
    # the largest gradient instead
    zero = {("params", "vae", "key_proj", "bias")}
    scale = max(np.linalg.norm(g) for g in want.values())
    for k in zero & set(want):
        assert max(np.linalg.norm(got[k]), np.linalg.norm(want[k])) <= 1e-6 * scale, k
    for k in set(want) - zero:
        # within 1e-4 of the float64 gradient, and of JAX's by 1e-4 plus
        # JAX's own float32 rounding (up to 1.2e-4 from float64 here)
        assert rel_l2(got[k], f64[k]) <= 1e-4, (k, rel_l2(got[k], f64[k]))
        assert rel_l2(got[k], want[k]) <= 1e-4 + rel_l2(want[k], f64[k]), k
    if kw.get("use_prior_flow") is False:  # no flow parameters at all
        assert not any("prior_flow" in k for k in want)


def test_flow_forward_matches_jax_and_inverts():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 12, 16).astype(np.float32)
    mask = np.ones((2, 12, 1), np.float32)
    mask[1, 9:] = 0.0
    g = rng.randn(2, 12, 64).astype(np.float32)
    jb = JBlock(16, 64, 3, 1, 4, 4, gin_channels=64)
    v = perturbed(jb.init(jax.random.PRNGKey(0), x, mask, g=g), seed=6)
    ref = np.asarray(jb.apply(v, x, mask, g=g, reverse=False))
    block = load_flax_variables(ResidualCouplingBlock(16, 64, 3, 1, 4, 4, gin_channels=64), v)

    def cf(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1)))

    with torch.no_grad():
        z = block(cf(x), cf(mask), g=cf(g), reverse=False)
        np.testing.assert_allclose(z.numpy().transpose(0, 2, 1), ref, rtol=1e-4, atol=1e-4)
        back = block(z, cf(mask), g=cf(g), reverse=True)
    got = back.numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(got[0], x[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1, :9], x[1, :9], rtol=0, atol=1e-5)
    assert np.abs(ref - x).max() > 0.1  # the flow moved its input
