"""The audio2motion models of the port — the Glow stack, the transformer
generator, the VQ-VAE and the discriminators (the CNN generator's
backbones: ``test_torch_a2m_cnn.py``) — against the JAX package's flax modules on the CPU, with
the same seeded numpy weights carried across by ``convert``, and the time
resample against ``jax.image.resize``.

Tolerances: forward outputs within 1e-5 of the reference's largest
magnitude (float32; sums run in another order); every parameter's gradient
of a seeded random projection of the outputs within 1e-4 relative L2
(the attention's key bias, whose gradient is zero in exact arithmetic,
below 1e-5 of the whole gradient's norm on both sides); the
resample within 1e-6 absolute (the same float32 weights, one dot product
each); the quantizer's code indices equal, its loss within rel 1e-5; the
Glow's inverse within 1e-4 of its input and its logdets within 1e-3
absolute of minus each other (the JAX package's own bounds).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from geneface_tpu.models.audio2motion import discriminators as jdisc
from geneface_tpu.models.audio2motion import flow as jflow
from geneface_tpu.models.audio2motion import transformer as jtr
from geneface_tpu.models.audio2motion import vqvae as jvq
from geneface_tpu_torch.convert import flax_param_tree, flax_variables, load_flax_variables
from geneface_tpu_torch.models.audio2motion import (
    CosineDiscriminator1DFactory,
    Discriminator,
    Discriminator1DFactory,
    Glow,
)
from geneface_tpu_torch.models.audio2motion.cnn_models import resample_time
from geneface_tpu_torch.models.audio2motion.transformer import (
    MultiHeadAttention,
    TransformerStyleFusionModel,
    sinusoidal_positions,
)
from geneface_tpu_torch.models.audio2motion.vqvae import VectorQuantizer, VQVAEModel

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_audio_helpers import flat, rel_l2  # noqa: E402

torch.set_num_threads(1)

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def seeded_variables(model, seed=0):
    """A flax tree in the layout of the port's ``model`` (``convert``'s
    names and shapes; the flax module then reads it, so a name or shape
    that differs fails there) filled from a seeded numpy stream: kernels
    ~ N(0, 1/fan_in), norm scales 1 ± 0.1, biases and the rest ~ 0.1·N(0, 1),
    InvConvNear's weight a random rotation, codebooks N(0, 1). No flax
    init is traced."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        n = np.asarray(rng.randn(*np.shape(leaf)))
        if name == "kernel":
            n = n / np.sqrt(np.prod(np.shape(leaf)[:-1]))
        elif name in ("scale", "pos_alpha"):
            n = 1.0 + 0.1 * n
        elif name == "weight":  # InvConvNear
            n = np.linalg.qr(n)[0]
        elif name != "codebook":
            n = 0.1 * n
        return n.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, flax_variables(model))


def check_parity(jfn, variables, model, tfn, name=""):
    """Forward outputs of ``jfn(variables)`` (JAX) and ``tfn(model)`` (the
    port, the same weights), then the gradients of ``Σ out·w`` for seeded
    ``w``, held to the module's bounds."""
    load_flax_variables(model, variables)
    model.eval()
    rng = np.random.RandomState(7)
    ws = [np.asarray(rng.randn(*o.shape), np.float32) for o in jax.eval_shape(jfn, variables)]

    def jloss(params):
        outs = jfn({**variables, "params": params})
        return sum(jnp.sum(o * w) for o, w in zip(outs, ws)), outs

    # the outputs and the gradients from one compiled function
    (_, outs), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables["params"])
    jgrad = flat(jgrad)
    touts = tfn(model)
    assert len(touts) == len(outs)
    for i, (t, o) in enumerate(zip(touts, outs)):
        o = np.asarray(o)
        assert t.shape == o.shape, (name, i, t.shape, o.shape)
        err = float(np.abs(t.detach().numpy() - o).max())
        assert err <= FWD_TOL * max(float(np.abs(o).max()), 1e-30), (name, i, err)
    sum((t * torch.as_tensor(w)).sum() for t, w in zip(touts, ws)).backward()
    got = flat(flax_param_tree(model, {n: p.grad if p.grad is not None else torch.zeros_like(p)
                                       for n, p in model.named_parameters()})["params"])
    assert set(got) == set(jgrad), (name, set(got) ^ set(jgrad))
    # the attention's key bias shifts all of a query's logits alike, which
    # the softmax ignores: its gradient is zero but for rounding, on both
    # sides, and is held below 1e-5 of the whole gradient's norm instead
    total = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64))) for g in jgrad.values()))
    zero = [k for k in jgrad if k[-2:] == ("key", "bias")]
    for k in zero:
        assert max(np.linalg.norm(got[k]), np.linalg.norm(jgrad[k])) <= 1e-5 * total, (name, k)
    worst = max((rel_l2(got[k], jgrad[k]), k) for k in jgrad if k not in zero)
    assert worst[0] <= GRAD_TOL, (name, worst)


# ------------------------------------------------------------- resample --
@pytest.mark.parametrize("T", [7, 8, 9])
def test_resample_matches_jax_image_resize(T):
    x = np.random.RandomState(T).randn(2, 3, T).astype(np.float32)
    for scale in (0.5, 2.0, 4.0, 0.25):
        n = int(T * scale)
        want = np.asarray(jax.image.resize(jnp.asarray(x.transpose(0, 2, 1)), (2, n, 3),
                                           method="linear")).transpose(0, 2, 1)
        got = resample_time(torch.as_tensor(x), scale).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the antialiasing that F.interpolate lacks: x = t² shrunk 8 → 4
    if T == 8:
        t2 = torch.arange(8.0)[None, None] ** 2
        np.testing.assert_allclose(resample_time(t2, 0.5)[0, 0].numpy(), [1, 7, 21, 40],
                                   atol=1e-5)


# ------------------------------------------------------------------ glow --
def test_glow_matches_jax_with_inverse_and_logdet():
    kw = dict(in_channels=8, hidden_channels=16, n_blocks=2, n_layers=2, n_split=4, n_sqz=2,
              gin_channels=4)
    jm = jflow.Glow(**kw)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 17, 8).astype(np.float32)  # odd T: the squeeze drops, then pads, one
    g = rng.randn(2, 17, 4).astype(np.float32)
    mask = np.ones((2, 17, 1), np.float32)
    mask[1, 12:] = 0.0
    tm = Glow(**kw)
    variables = seeded_variables(tm)

    def jfn(v, reverse=False, inp=x):
        return jm.apply(v, inp, mask, g, reverse=reverse)

    def tfn(m, reverse=False, inp=x):
        z, logdet = m(torch.as_tensor(inp).transpose(1, 2), torch.as_tensor(mask).transpose(1, 2),
                      torch.as_tensor(g).transpose(1, 2), reverse=reverse)
        return z.transpose(1, 2), logdet

    check_parity(jfn, variables, tm, tfn, "glow")
    z, logdet = tfn(tm)
    jz = np.asarray(jfn(variables)[0])
    back, logdet_r = tfn(tm, reverse=True, inp=jz)
    jback, jlogdet_r = jfn(variables, reverse=True, inp=jz)
    err = float((back.detach() - torch.as_tensor(np.asarray(jback))).abs().max())
    assert err <= FWD_TOL * float(np.abs(np.asarray(jback)).max())
    np.testing.assert_allclose(logdet_r.detach().numpy(), np.asarray(jlogdet_r), rtol=1e-5,
                               atol=1e-4)
    # the inverse undoes the flow on the frames the squeeze keeps
    keep = mask[:, :16]
    np.testing.assert_allclose(back.detach().numpy()[:, :16] * keep, x[:, :16] * keep,
                               atol=1e-4)
    np.testing.assert_allclose(logdet.detach().numpy(), -logdet_r.detach().numpy(), atol=1e-3)


# ----------------------------------------------------------- transformer --
def test_attention_all_padding_row_is_uniform():
    """flax fills masked logits with the dtype's most negative value: a row
    whose keys are all padding averages the values uniformly, not NaN."""
    jm = fnn.MultiHeadDotProductAttention(num_heads=2, qkv_features=8)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 8).astype(np.float32)
    keep = np.ones((2, 5), bool)
    keep[1] = False
    tm = MultiHeadAttention(8, 2, 8)
    variables = seeded_variables(tm)
    want = np.asarray(jm.apply(variables, x, x, mask=keep[:, None, None, :]))
    load_flax_variables(tm, variables)
    got = tm(torch.as_tensor(x), torch.as_tensor(keep)).detach().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    v = x[1] @ np.asarray(variables["params"]["value"]["kernel"]).reshape(8, 8) + np.asarray(
        variables["params"]["value"]["bias"]).reshape(8)
    np.testing.assert_allclose(got[1], np.broadcast_to(
        v.mean(0) @ np.asarray(variables["params"]["out"]["kernel"]).reshape(8, 8)
        + np.asarray(variables["params"]["out"]["bias"]), (5, 8)), atol=1e-5)
    assert set(flat(flax_variables(tm))) == set(flat(variables))
    np.testing.assert_array_equal(flat(flax_variables(tm))[("params", "out", "kernel")],
                                  variables["params"]["out"]["kernel"])


def test_transformer_model_matches_jax():
    np.testing.assert_array_equal(sinusoidal_positions(7, 5), jtr.sinusoidal_positions(7, 5))
    jm = jtr.TransformerStyleFusionModel(out_dim=12)
    rng = np.random.RandomState(4)
    B, T = 2, 10
    mask = np.ones((B, T), np.float32)
    mask[1, 7:] = 0.0
    args = (rng.randn(B, T, 29).astype(np.float32), rng.randn(B, T, 1).astype(np.float32),
            rng.randn(B, 135).astype(np.float32), mask)
    tm = TransformerStyleFusionModel(out_dim=12)
    check_parity(lambda v: (jm.apply(v, *args),), seeded_variables(tm), tm,
                 lambda m: (m(*map(torch.as_tensor, args)),), "transformer")


# ----------------------------------------------------------------- vqvae --
def test_vector_quantizer_indices_and_losses():
    jm = jvq.VectorQuantizer(dim=12, codebook_size=16, codebook_dim=4)
    rng = np.random.RandomState(5)
    z = rng.randn(2, 9, 12).astype(np.float32)
    tm = VectorQuantizer(12, 16, 4)
    variables = seeded_variables(tm)
    cb = np.array(variables["params"]["codebook"])
    cb[7] = cb[3]  # a tie: both sides take the first index
    variables["params"]["codebook"] = cb
    zq, idx, loss = jm.apply(variables, z)
    load_flax_variables(tm, variables)
    tzq, tidx, tloss = tm(torch.as_tensor(z))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    assert not (tidx.numpy() == 7).any()
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    np.testing.assert_allclose(tzq.detach().numpy(), np.asarray(zq), rtol=0, atol=1e-5)
    # the straight-through gradient reaches the input
    zt = torch.as_tensor(z).requires_grad_()
    tm(zt)[0].sum().backward()
    assert float(zt.grad.abs().max()) > 0


def test_vqvae_model_matches_jax():
    jm = jvq.VQVAEModel(in_out_dim=12, hidden_channels=32)
    rng = np.random.RandomState(6)
    B, T = 2, 20
    hubert = rng.randn(B, 2 * T, 64).astype(np.float32)
    x = rng.randn(B, T, 12).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    key = jax.random.PRNGKey(3)
    tm = VQVAEModel(in_out_dim=12, audio_in_dim=64, hidden_channels=32)
    variables = seeded_variables(tm)
    # the encoder's noise: the JAX draw, passed to the port
    noise = np.asarray(jax.random.normal(key, tm.noise_shape(B, T)))

    def jfn(v):
        out = jm.apply(v, hubert, x, mask, key)
        return out["pred"], out["commit_loss"], out["z_q"], out["m_q"]

    def tfn(m):
        out = m(*map(torch.as_tensor, (hubert, x, mask, noise)))
        return out["pred"], out["commit_loss"], out["z_q"], out["m_q"]

    check_parity(jfn, variables, tm, tfn, "vqvae")
    # inference: the JAX draw of code indices, decoded on both sides
    ikey = jax.random.PRNGKey(8)
    want = np.asarray(jm.apply(variables, hubert, ikey, method=jm.infer))
    idx = np.asarray(jax.random.randint(ikey, (B, tm.vae.latent_length(T)), 0, 256))
    got = tm.infer(torch.as_tensor(hubert), torch.as_tensor(idx)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL * np.abs(want).max())
    sampled = tm.infer(torch.as_tensor(hubert), generator=torch.Generator().manual_seed(0))
    assert sampled.shape == (B, T, 12) and torch.isfinite(sampled).all()


# --------------------------------------------------------- discriminators --
@pytest.mark.parametrize("disc_type", ["standard", "cosine"])
def test_discriminator_matches_jax(disc_type):
    jm = jdisc.Discriminator(x_dim=48, y_dim=12, time_lengths=(8, 16), disc_type=disc_type)
    rng = np.random.RandomState(8)
    x = rng.randn(2, 30, 12).astype(np.float32)
    x[1, 26:] = 0.0
    mel = rng.randn(2, 60, 48).astype(np.float32)
    starts = (3, 100)  # the second clamped to T - 16
    tm = Discriminator(x_dim=48, y_dim=12, time_lengths=(8, 16), disc_type=disc_type)
    check_parity(lambda v: (jm.apply(v, x, mel, starts),), seeded_variables(tm), tm,
                 lambda m: (m(torch.as_tensor(x), torch.as_tensor(mel), starts),), disc_type)


@pytest.mark.parametrize("time_length", [1, 3, 8])
def test_factories_match_jax(time_length):
    rng = np.random.RandomState(time_length)
    x = rng.randn(3, time_length, 6).astype(np.float32)
    jm = jdisc.Discriminator1DFactory(time_length, in_dim=6, hidden_size=16)
    tm = Discriminator1DFactory(time_length, in_dim=6, hidden_size=16)
    check_parity(lambda v: (jm.apply(v, x)[0], *jm.apply(v, x)[1]), seeded_variables(tm), tm,
                 lambda m: (lambda out: (out[0], *out[1]))(m(torch.as_tensor(x))),
                 f"factory {time_length}")
    if time_length == 8:
        x2 = rng.randn(3, 8, 6).astype(np.float32)
        jc = jdisc.CosineDiscriminator1DFactory(8, in_dim=6, hidden_size=16)
        tc = CosineDiscriminator1DFactory(8, in_dim=6, hidden_size=16)
        check_parity(lambda v: (jc.apply(v, x, x2)[0],), seeded_variables(tc), tc,
                     lambda m: (m(torch.as_tensor(x), torch.as_tensor(x2))[0],), "cosine")
