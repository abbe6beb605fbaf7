"""The port's 3DMM tracker (``geneface_tpu_torch/datagen/face_tracker.py``)
against the JAX package's on the CPU, on a seeded 20×20 sphere-cap basis.

- ``project_landmarks``: float32 sums in another order; held to 1e-5 of
  max |ref| (measured ~2e-7).
- ``fit_sequence`` at reduced steps, three focals with the planted one far
  from the others: the same focal, and the tracks within 1e-4 of each
  array's max |ref| (measured ≤ 5e-6: every step's gradient agrees to a
  few float32 steps and Adam's steps here are far from its eps).
- the photometric fit, global and with ``("id", "tex")`` frozen: at each
  step the port's gradient against ``jax.grad`` of the JAX objective at the
  port's own parameters (1e-4 of each gradient's max |ref|: the splat's
  sums in another order, and the division by the splat weight; measured
  ≤ 2e-6 at the first step), and the port's update against ``optax`` (``multi_transform``
  with ``set_to_zero``, as the JAX package builds it) applied to the port's
  own gradients (1e-6 of each parameter's max |value|, plus 1e-3·lr: the
  first Adam steps on gradients near eps turn last-bit differences into a
  part of ``lr``). The frozen groups neither move nor keep moments.
- ``refine_photometric`` end to end at a few steps, the last chunk wrapping
  over frames already refined: within 1e-3 of each array's max |ref|
  (measured ≤ 3e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_datagen_helpers import (
    jax_full_basis,
    jax_lm_basis,
    max_rel,
    smooth_track,
    sphere_cap,
    torch_full_basis,
    torch_lm_basis,
)

from geneface_tpu.datagen import face_tracker as JT
from geneface_tpu.datagen.face_renderer import render_vertices_soft as jax_render
from geneface_tpu.datagen.face_renderer import sh9_irradiance as jax_sh9
from geneface_tpu.datagen.face_renderer import vertex_normals as jax_normals
from geneface_tpu_torch.datagen import face_tracker as PT

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)

H = W = 64
T = 5
FOCAL = 250.0
CXY = np.array([W / 2.0, H / 2.0], np.float32)
KEYS = ("id", "exp", "euler", "trans")


@pytest.fixture(scope="module")
def world():
    rng = np.random.RandomState(0)
    b = sphere_cap(rng)
    tr = smooth_track(rng, T, 6, 4)
    jb = jax_full_basis(b)

    @jax.jit
    def render(params):
        cam = JT._cam_geometry(jb, *(params[k] for k in KEYS))
        light = jnp.zeros((T, 27)).at[:, 2].set(0.3)
        colors = jb.tex_mean.reshape(1, -1, 3) * jax_sh9(jax_normals(cam, jb.tris), light)
        return jax_render(cam, colors, FOCAL, jnp.asarray(CXY), H, W, scale=2)[0]

    rgb = render({k: jnp.asarray(tr[k]) for k in KEYS})
    frames = np.kron(np.asarray(rgb), np.ones((1, 2, 2, 1), np.float32))  # [T, H, W, 3]
    lms = np.asarray(JT.project_landmarks(jax_lm_basis(b), *(jnp.asarray(tr[k]) for k in KEYS),
                                          jnp.float32(FOCAL), jnp.asarray(CXY)))
    lms = lms + rng.randn(*lms.shape).astype(np.float32)
    return {"b": b, "tr": tr, "frames": frames, "lms": lms,
            "jlm": jax_lm_basis(b), "plm": torch_lm_basis(b), "jfb": jb,
            "pfb": torch_full_basis(b)}


def test_project_landmarks(world):
    tr = world["tr"]
    ref = JT.project_landmarks(world["jlm"], *(jnp.asarray(tr[k]) for k in KEYS),
                               jnp.float32(FOCAL), jnp.asarray(CXY))
    got = PT.project_landmarks(world["plm"], *(torch.as_tensor(tr[k]) for k in KEYS), FOCAL,
                               torch.as_tensor(CXY))
    assert got.shape == (T, 68, 2)
    assert max_rel(got, ref) <= 1e-5
    # a leading candidate axis with one focal each is each candidate alone
    lead = PT.project_landmarks(
        world["plm"], torch.as_tensor(np.stack([tr["id"]] * 2)),
        *(torch.as_tensor(np.stack([tr[k]] * 2)) for k in KEYS[1:]),
        torch.tensor([FOCAL, 2 * FOCAL]), torch.as_tensor(CXY))
    assert max_rel(lead[0], got) <= 1e-6
    assert max_rel(lead[1], PT.project_landmarks(
        world["plm"], *(torch.as_tensor(tr[k]) for k in KEYS), 2 * FOCAL,
        torch.as_tensor(CXY))) <= 1e-6


def test_fit_sequence_picks_the_same_focal(world):
    """Planted focal 250 among (250, 800, 1600); 40 coarse steps on every
    second frame, 60 joint steps."""
    kw = dict(focal_candidates=(800, 250, 1600), coarse_steps=40, refine_steps=60,
              coarse_every=2)
    ref = JT.fit_sequence(world["lms"], world["jlm"], H, W, **kw)
    got = PT.fit_sequence(world["lms"], world["plm"], H, W, device="cpu", **kw)
    assert got["focal"] == ref["focal"] == 250.0
    assert abs(got["loss"] - ref["loss"]) <= 1e-4 * abs(ref["loss"])
    for k in KEYS:
        assert got[k].shape == ref[k].shape
        assert max_rel(got[k], ref[k]) <= 1e-4, k


def _photo_init(world, rng):
    tr = world["tr"]
    return {"id": tr["id"], "exp": tr["exp"] + 0.05 * rng.randn(T, 4).astype(np.float32),
            "euler": tr["euler"] + 0.02, "trans": tr["trans"] + 0.01,
            "tex": np.zeros(3, np.float32), "light": (rng.randn(T, 27) * 0.1).astype(np.float32)}


@pytest.mark.parametrize("frozen", [(), ("id", "tex")], ids=["global", "per_frame"])
def test_photo_fit_steps_match_jax_and_optax(world, frozen, monkeypatch):
    steps, lr = 3, 0.02
    init = _photo_init(world, np.random.RandomState(1))
    frames_ds = world["frames"][:, ::2, ::2]  # stand-in target at the render's size
    lms = world["lms"]
    seen = []
    real = PT._adam_update

    def spy(params, grads, state, lr):
        seen.append(({k: v.detach().clone() for k, v in params.items()},
                     {k: g.clone() for k, g in grads.items()}))
        real(params, grads, state, lr)

    monkeypatch.setattr(PT, "_adam_update", spy)
    got, aux = PT._photo_fit(
        world["pfb"], torch.as_tensor(frames_ds), torch.as_tensor(lms), torch.tensor(FOCAL),
        torch.as_tensor(CXY), {k: torch.as_tensor(v) for k, v in init.items()},
        steps=steps, lr=lr, H=H, W=W, scale=2, frozen=frozen)
    assert len(seen) == steps
    assert all(set(g) == set(PT._PHOTO_KEYS) - set(frozen) for _, g in seen)

    jfb = world["jfb"]

    def jloss(p):
        return JT._photo_loss(p, jfb, frames_ds, lms, FOCAL, jnp.asarray(CXY), H, W, 2,
                              1.0, 1e-3, 1.0, 1e-3, 1e-3, 0.05)

    jgrad = jax.jit(jax.grad(jloss, has_aux=True))
    tx = optax.multi_transform(
        {"train": optax.adam(lr), "frozen": optax.set_to_zero()},
        lambda tree: {k: ("frozen" if k in frozen else "train") for k in tree})
    params = {k: jnp.asarray(v) for k, v in init.items()}
    opt = tx.init(params)
    for i, (p_port, g_port) in enumerate(seen):
        for k in PT._PHOTO_KEYS:  # the port's own trajectory so far is optax's
            bound = 1e-6 * float(jnp.abs(params[k]).max()) + 1e-3 * lr
            assert float(np.abs(p_port[k].numpy() - np.asarray(params[k])).max()) <= bound, (i, k)
        g_ref, _ = jgrad({k: jnp.asarray(v.numpy()) for k, v in p_port.items()})
        for k, g in g_port.items():
            assert max_rel(g, g_ref[k]) <= 1e-4, (i, k)
        full = {k: jnp.asarray(g_port[k].numpy()) if k in g_port else jnp.zeros_like(params[k])
                for k in params}
        upd, opt = tx.update(full, opt)
        params = optax.apply_updates(params, upd)
    for k in PT._PHOTO_KEYS:
        bound = 1e-6 * float(jnp.abs(params[k]).max()) + 1e-3 * lr
        assert float(np.abs(got[k].numpy() - np.asarray(params[k])).max()) <= bound, k
    for k in frozen:  # frozen: unmoved
        assert np.array_equal(got[k].numpy(), init[k])
    # the reported terms are those of the last step, before its update
    _, ref_aux = PT._photo_loss(
        seen[-1][0], world["pfb"], torch.as_tensor(frames_ds), torch.as_tensor(lms),
        torch.tensor(FOCAL), torch.as_tensor(CXY), H, W, 2, 1.0, 1e-3, 1.0, 1e-3, 1e-3, 0.05)
    for k in ("col", "lan", "lap"):
        assert float(aux[k]) == float(ref_aux[k])


def test_refine_photometric_end_to_end(world):
    """Global stage on 3 of 5 frames, then chunks of 3: frames 0-2 and,
    wrapping, 2-4 (frame 2 refined twice), as the JAX package does."""
    rng = np.random.RandomState(2)
    track = {k: np.asarray(v) for k, v in world["tr"].items()}
    track["euler"] = track["euler"] + 0.02 * rng.randn(T, 3).astype(np.float32)
    track["focal"] = FOCAL
    kw = dict(scale=2, global_steps=4, frame_steps=3, photo_batch=3)
    ref = JT.refine_photometric(track, world["jfb"], world["frames"], world["lms"], H, W, **kw)
    got = PT.refine_photometric(track, world["pfb"], world["frames"], world["lms"], H, W,
                                device="cpu", **kw)
    assert np.isfinite(got["photo_loss"])
    assert abs(got["photo_loss"] - ref["photo_loss"]) <= 1e-3 * abs(ref["photo_loss"])
    for k in ("euler", "trans", "exp", "id", "tex", "light"):
        assert np.asarray(got[k]).shape == np.asarray(ref[k]).shape, k
        assert max_rel(got[k], ref[k]) <= 1e-3, k
    assert got["focal"] == FOCAL
