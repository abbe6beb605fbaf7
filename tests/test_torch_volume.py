"""The port's vanilla volume rendering (``ops/volume.py``) against the JAX
package's: the compositing, the importance sampling and the coarse+fine
render, forward and gradient, deterministic and jittered (the JAX draws
taken from its own keys and fed to the port).

Tolerances: forwards within 1e-5 of max |ref| (float32 sums in another
order); gradients within a relative L2 error of 1e-4. ``sample_pdf``'s
``denom < 1e-5`` switch sits on its threshold for a fully opaque ray (an
empty bin's step is 9.9948e-6), so the inputs here keep every bin clear of
it; the render tests use fields that leave rays translucent. The
deterministic render's last importance sample sits at u = 1.0, on the CDF's
last entry, which the two cumsums round apart in the last bits; where the
last CDF step is also small, that sample moves by a share of a bin, so
``z_std`` is held on the other rays (see the test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneface_tpu.ops import volume as jvol
from geneface_tpu_torch.ops import volume as tvol

torch.set_num_threads(1)

FWD = 1e-5
GRAD = 1e-4


def close(got, ref, bound=FWD):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= bound * scale, np.abs(got - ref).max() / scale


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def rays(rng, n):
    o = (rng.randn(n, 3) * 0.05).astype(np.float32)
    o[:, 2] += 1.0
    d = np.stack([rng.randn(n) * 0.2, rng.randn(n) * 0.2, -np.ones(n)], -1).astype(np.float32)
    return o, d


@pytest.mark.parametrize("bc, white, noise", [(True, False, False), (False, True, False),
                                              (True, False, True)],
                         ids=["background", "white", "sigma_noise"])
def test_raw2outputs_matches_jax(bc, white, noise):
    rng = np.random.RandomState(0)
    N, S = 64, 12
    raw = rng.randn(N, S, 4).astype(np.float32)
    z = np.sort(rng.uniform(0.3, 0.9, (N, S)), -1).astype(np.float32)
    _, d = rays(rng, N)
    bg = rng.rand(N, 3).astype(np.float32) if bc else None
    std = 0.5 if noise else 0.0
    # JAX draws its own normal: the port gets the same draws from its key
    eps = np.array(jax.random.normal(jax.random.PRNGKey(3), (N, S))) if noise else None
    ref = jvol.raw2outputs(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(d),
                           None if bg is None else jnp.asarray(bg),
                           rng=jax.random.PRNGKey(3) if noise else None, raw_noise_std=std,
                           white_bkgd=white)
    got = tvol.raw2outputs(torch.as_tensor(raw), torch.as_tensor(z), torch.as_tensor(d),
                           None if bg is None else torch.as_tensor(bg),
                           noise=None if eps is None else torch.as_tensor(eps),
                           raw_noise_std=std, white_bkgd=white)
    assert set(got) == set(ref)
    for k in ref:
        close(got[k].numpy(), ref[k], FWD)


@pytest.mark.parametrize("det", [True, False], ids=["even", "drawn"])
def test_sample_pdf_matches_jax(det):
    rng = np.random.RandomState(1)
    N, B, n = 96, 15, 24
    bins = np.sort(rng.uniform(0.3, 0.9, (N, B)), -1).astype(np.float32)
    # weights well above the 1e-5 floor keep every CDF step clear of the
    # denom switch
    w = rng.uniform(0.01, 1.0, (N, B - 1)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = jvol.sample_pdf(jnp.asarray(bins), jnp.asarray(w), n, rng=None if det else key,
                          det=det)
    u = None if det else torch.as_tensor(np.array(jax.random.uniform(key, (N, n))))
    got = tvol.sample_pdf(torch.as_tensor(bins), torch.as_tensor(w), n, u=u)
    close(got.numpy(), ref, FWD)


def _field(rng, hidden=16):
    """A small analytic field of the sample positions: ``raw = tanh(sin(3
    pts) @ W1) @ W2``, with W2's sigma column scaled so rays stay
    translucent."""
    w1 = (rng.randn(3, hidden) * 0.8).astype(np.float32)
    w2 = (rng.randn(hidden, 4) * 0.6).astype(np.float32)
    w2[:, 3] = np.abs(w2[:, 3]) * 0.5
    return w1, w2


def _jquery(w1, w2):
    def q(pts, fine):
        h = jnp.tanh(jnp.sin(3.0 * pts) @ w1)
        return h @ (w2 * (1.1 if fine else 1.0))
    return q


def _tquery(w1, w2):
    def q(pts, fine):
        h = torch.tanh(torch.sin(3.0 * pts) @ w1)
        return h @ (w2 * (1.1 if fine else 1.0))
    return q


def _jax_draws(key, N, ns, nf):
    """The jitter and importance draws JAX's ``render_rays`` takes from
    ``key``."""
    _, k_strat, _, k_pdf, _ = jax.random.split(key, 5)
    return (np.array(jax.random.uniform(k_strat, (N, ns))),
            np.array(jax.random.uniform(k_pdf, (N, nf))))


def _jax_sigma_noise(key, N, ns, nf):
    """The standard normals JAX's ``render_rays`` adds to sigma (coarse,
    fine) under ``raw_noise_std``."""
    _, _, k_noise, _, k_noise2 = jax.random.split(key, 5)
    return (np.array(jax.random.normal(k_noise, (N, ns))),
            np.array(jax.random.normal(k_noise2, (N, ns + nf))))


@pytest.mark.parametrize("jitter, variant", [(False, None), (True, None),
                                             (True, "linear_disp_sigma_noise")],
                         ids=["deterministic", "jittered", "linear_disp_sigma_noise"])
def test_render_rays_forward_matches_jax(jitter, variant):
    rng = np.random.RandomState(2)
    N, ns, nf = 48, 8, 8
    o, d = rays(rng, N)
    bg = rng.rand(N, 3).astype(np.float32)
    w1, w2 = _field(rng)
    key = jax.random.PRNGKey(7)
    extra = dict(raw_noise_std=0.5, linear_disp=True) if variant else {}
    ref = jvol.render_rays(_jquery(jnp.asarray(w1), jnp.asarray(w2)), jnp.asarray(o),
                           jnp.asarray(d), 0.3, 0.9, jnp.asarray(bg), n_samples=ns,
                           n_importance=nf, rng=key if jitter else None, **extra)
    draws = {}
    if jitter:
        t_rand, u = _jax_draws(key, N, ns, nf)
        draws = {"t_rand": torch.as_tensor(t_rand), "u": torch.as_tensor(u)}
    if variant:
        noise, noise_fine = _jax_sigma_noise(key, N, ns, nf)
        draws.update(noise=torch.as_tensor(noise), noise_fine=torch.as_tensor(noise_fine))
    got = tvol.render_rays(_tquery(torch.as_tensor(w1), torch.as_tensor(w2)),
                           torch.as_tensor(o), torch.as_tensor(d), 0.3, 0.9,
                           torch.as_tensor(bg), n_samples=ns, n_importance=nf, **draws,
                           **extra)
    assert set(ref) <= set(got)
    same = np.ones(N, bool)
    if not jitter:
        # the even draws end at u = 1.0, on the CDF's last entry, which the
        # two frameworks' cumsums round apart (torch 0.99999994, XLA
        # 1.0000001 on 17 of these 48 rays); with a small last CDF step that
        # moves the ray's last importance sample by a share of a bin (see
        # _end_cannot_flip): z_std is held on the other rays
        same = _end_cannot_flip(w1, w2, o, d, bg, ns)
        assert same.sum() >= N // 2, same.sum()
    for k in ref:
        if k == "z_std":
            close(got[k].numpy()[same], np.asarray(ref[k])[same], FWD)
        else:
            close(got[k].numpy(), ref[k], FWD)


def _end_cannot_flip(w1, w2, o, d, bg, ns):
    """Per ray: False where either CDF ends at or over 1.0 and the last CDF
    step is under 1e-2. The sample at u = 1.0 takes the last bin's top
    exactly where the CDF ends under 1.0, and else ``top - (end - 1)/step``
    of the bin: the last bits of ``end`` then move it by up to 1.7e-3 of a
    bin here (a step of 7e-5), against ~1e-5 for a step of 1e-2."""
    N = o.shape[0]
    t = np.linspace(0, 1, ns, dtype=np.float32)
    z = np.broadcast_to(0.3 * (1 - t) + 0.9 * t, (N, ns)).astype(np.float32)

    def cdf(w, cumsum, total):
        w = w[:, 1:-1] + 1e-5
        return np.asarray(cumsum(w / total(w)))

    pts = torch.as_tensor(o)[:, None] + torch.as_tensor(d)[:, None] * torch.as_tensor(z)[..., None]
    raw = _tquery(torch.as_tensor(w1), torch.as_tensor(w2))(pts, False)
    tw = tvol.raw2outputs(raw, torch.as_tensor(z), torch.as_tensor(d), torch.as_tensor(bg))
    t_cdf = cdf(tw["weights"], lambda x: torch.cumsum(x, -1), lambda x: x.sum(-1, keepdim=True))
    jpts = jnp.asarray(o)[:, None] + jnp.asarray(d)[:, None] * jnp.asarray(z)[..., None]
    jraw = _jquery(jnp.asarray(w1), jnp.asarray(w2))(jpts, False)
    jw = jvol.raw2outputs(jraw, jnp.asarray(z), jnp.asarray(d), jnp.asarray(bg))
    j_cdf = cdf(jw["weights"], lambda x: jnp.cumsum(x, -1),
                lambda x: jnp.sum(x, -1, keepdims=True))
    exact = (t_cdf[:, -1] < 1.0) & (j_cdf[:, -1] < 1.0)
    return exact | (t_cdf[:, -1] - t_cdf[:, -2] >= 1e-2)


def test_render_rays_gradient_matches_jax():
    """d(MSE of the fine and coarse maps)/d(field weights), jittered."""
    rng = np.random.RandomState(3)
    N, ns, nf = 48, 8, 8
    o, d = rays(rng, N)
    bg = rng.rand(N, 3).astype(np.float32)
    gt = rng.rand(N, 3).astype(np.float32)
    w1, w2 = _field(rng)
    key = jax.random.PRNGKey(11)

    def jloss(w1, w2):
        out = jvol.render_rays(_jquery(w1, w2), jnp.asarray(o), jnp.asarray(d), 0.3, 0.9,
                               jnp.asarray(bg), n_samples=ns, n_importance=nf, rng=key)
        return (jnp.mean((out["rgb_map"] - gt) ** 2)
                + jnp.mean((out["rgb_map_coarse"] - gt) ** 2))

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(w1), jnp.asarray(w2))
    t_rand, u = _jax_draws(key, N, ns, nf)
    tw1 = torch.tensor(w1, requires_grad=True)
    tw2 = torch.tensor(w2, requires_grad=True)
    out = tvol.render_rays(_tquery(tw1, tw2), torch.as_tensor(o), torch.as_tensor(d), 0.3,
                           0.9, torch.as_tensor(bg), n_samples=ns, n_importance=nf,
                           t_rand=torch.as_tensor(t_rand), u=torch.as_tensor(u))
    g = torch.as_tensor(gt)
    loss = torch.mean((out["rgb_map"] - g) ** 2) + torch.mean((out["rgb_map_coarse"] - g) ** 2)
    loss.backward()
    close(loss.item(), float(jl), FWD)
    assert rel_l2(tw1.grad.numpy(), jg[0]) < GRAD
    assert rel_l2(tw2.grad.numpy(), jg[1]) < GRAD


def test_z_std_is_population_std_and_samples_replay():
    """``z_std`` divides by n (JAX's ``jnp.std``); feeding a render its own
    ``z_samples`` back gives the same fine pass, bit for bit, and the
    importance samples carry no gradient."""
    rng = np.random.RandomState(4)
    N, ns, nf = 32, 8, 6
    o, d = rays(rng, N)
    w1, w2 = _field(rng)
    w2t = torch.tensor(w2, requires_grad=True)
    q = _tquery(torch.as_tensor(w1), w2t)
    args = (torch.as_tensor(o), torch.as_tensor(d), 0.3, 0.9, None)
    out = tvol.render_rays(q, *args, n_samples=ns, n_importance=nf)
    zs = out["z_samples"]
    assert not zs.requires_grad
    np.testing.assert_allclose(out["z_std"].detach().numpy(), zs.numpy().std(-1), rtol=1e-5,
                               atol=1e-7)
    again = tvol.render_rays(q, *args, n_samples=ns, n_importance=nf, z_samples=zs)
    assert torch.equal(again["rgb_map"], out["rgb_map"])
