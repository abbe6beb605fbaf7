"""The port's soft-splat face renderer
(``geneface_tpu_torch/datagen/face_renderer.py``) against the JAX package's
on the CPU: a seeded 20×20 sphere-cap mesh, 3 frames at 64², scale 2.

The normals' and the splat's sums run on the plain version of the row
scatter-add K1 here (their backward on K8's plain gather), XLA's scatter on
the JAX side: the same float32 terms summed in another order, a few
rounding steps apart (measured ≤ 3e-7 of max |ref|). Every forward value
and gradient is held to 1e-5 of the reference's max |value|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_datagen_helpers import jax_full_basis, max_rel, smooth_track, sphere_cap, torch_full_basis

from geneface_tpu.datagen import face_renderer as J
from geneface_tpu.datagen.face_tracker import _cam_geometry as jax_cam_geometry
from geneface_tpu_torch.datagen import face_renderer as P
from geneface_tpu_torch.ops import scatter as scatter_mod

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)

TOL = 1e-5
T, H, W, SCALE = 3, 64, 64, 2
FOCAL = 120.0
CXY = np.array([32.0, 32.0], np.float32)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(0)
    b = sphere_cap(rng)
    jb = jax_full_basis(b)
    tr = smooth_track(rng, T, 6, 4)
    cam = np.array(jax_cam_geometry(jb, *(jnp.asarray(tr[k])
                                          for k in ("id", "exp", "euler", "trans"))))
    cam[0, :5, 0] += 5.0  # vertices off the frame
    stray = cam.copy()  # and behind the camera, and at z = 0
    stray[1, 5:10, 2] = -1.0
    stray[2, 10:12, 2] = 0.0
    return {
        "b": b, "jb": jb, "pb": torch_full_basis(b), "cam": cam, "stray": stray,
        "colors": rng.rand(T, cam.shape[1], 3).astype(np.float32),
        "target": rng.rand(T, H // SCALE, W // SCALE, 3).astype(np.float32),
        "gamma": (rng.randn(T, 27) * 0.3).astype(np.float32),
        "wts": rng.randn(*cam.shape).astype(np.float32),
    }


def _render_jax(cam, colors):
    return J.render_vertices_soft(cam, colors, FOCAL, jnp.asarray(CXY), H, W, scale=SCALE)


def _render_port(cam, colors):
    return P.render_vertices_soft(cam, colors, FOCAL, torch.as_tensor(CXY), H, W, scale=SCALE)


def test_vertex_normals_and_their_gradient(scene):
    jb, pb, cam, wts = scene["jb"], scene["pb"], scene["cam"], scene["wts"]
    _, ref_g = jax.jit(jax.value_and_grad(
        lambda c: jnp.sum(J.vertex_normals(c, jb.tris) * wts)))(cam)
    ref_n = jax.jit(lambda c: J.vertex_normals(c, jb.tris))(cam)
    c = torch.tensor(cam, requires_grad=True)
    n = P.vertex_normals(c, pb.tris)
    (n * torch.as_tensor(wts)).sum().backward()
    assert n.shape == (T, cam.shape[1], 3)
    assert max_rel(n, ref_n) <= TOL
    assert max_rel(c.grad, ref_g) <= TOL
    # unit length where a vertex has triangles
    np.testing.assert_allclose(n.detach().norm(dim=-1).numpy(), 1.0, atol=1e-5)


def test_vertex_normals_without_triangles(scene):
    cam = torch.as_tensor(scene["cam"])
    empty = torch.zeros(0, 3, dtype=torch.int64)
    ref = np.asarray(J.vertex_normals(jnp.asarray(scene["cam"]), jnp.zeros((0, 3), jnp.int32)))
    got = P.vertex_normals(cam, empty)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (got[..., 2] == 1).all() and (got[..., :2] == 0).all()


def test_sh9_irradiance_and_its_gradient(scene):
    cam, gamma = scene["cam"], scene["gamma"]
    normals = np.asarray(J.vertex_normals(jnp.asarray(cam), scene["jb"].tris))
    wts = scene["wts"]
    ref, (gn, gg) = jax.jit(jax.value_and_grad(
        lambda n, g: jnp.sum(J.sh9_irradiance(n, g) * wts), argnums=(0, 1)))(normals, gamma)
    n = torch.tensor(normals, requires_grad=True)
    g = torch.tensor(gamma, requires_grad=True)
    irr = P.sh9_irradiance(n, g)
    (irr * torch.as_tensor(wts)).sum().backward()
    assert max_rel(irr, J.sh9_irradiance(jnp.asarray(normals), jnp.asarray(gamma))) <= TOL
    assert max_rel(n.grad, gn) <= TOL and max_rel(g.grad, gg) <= TOL


@pytest.mark.parametrize("which", ["cam", "stray"])
def test_render_forward(scene, which):
    ref_rgb, ref_w = jax.jit(_render_jax)(scene[which], scene["colors"])
    rgb, w = _render_port(torch.as_tensor(scene[which]), torch.as_tensor(scene["colors"]))
    assert rgb.shape == (T, H // SCALE, W // SCALE, 3) and w.shape == (T, H // SCALE, W // SCALE)
    assert float(w[0].max()) > 0.5  # the face is on screen
    assert max_rel(rgb, ref_rgb) <= TOL
    assert max_rel(w, ref_w) <= TOL


def test_offscreen_and_behind_camera_vertices_are_dropped(scene):
    """Frame 0's five vertices pushed off the frame add nothing. A vertex at
    z <= 1e-5 projects ~1e7 pixels away (torch's float -> int32 cast of that
    is not XLA's) and is dropped; it also sets the frame's nearest depth to
    1e-5, against which every other vertex's depth weight underflows, so
    frames 1 and 2 draw nothing, on both sides."""
    cam, colors = scene["stray"], scene["colors"]
    _, ref_w = jax.jit(_render_jax)(cam, colors)
    rgb, w = _render_port(torch.as_tensor(cam), torch.as_tensor(colors))
    rgb0, w0 = _render_port(torch.as_tensor(cam[:1, 5:]), torch.as_tensor(colors[:1, 5:]))
    assert max_rel(w[:1], w0) <= TOL and max_rel(rgb[:1], rgb0) <= TOL
    assert float(w[1:].abs().max()) == 0.0 == float(jnp.abs(ref_w[1:]).max())
    assert float(rgb[1:].abs().max()) == 0.0


def test_render_gradients_through_the_photometric_loss(scene):
    cam, colors, target = scene["cam"], scene["colors"], scene["target"]

    def jloss(c, col):
        rgb, w = _render_jax(c, col)
        return J.photometric_loss(rgb, w, target)

    ref, (gc, gcol) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(cam, colors)
    c = torch.tensor(cam, requires_grad=True)
    col = torch.tensor(colors, requires_grad=True)
    rgb, w = _render_port(c, col)
    loss = P.photometric_loss(rgb, w, torch.as_tensor(target))
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - float(ref)) <= TOL * abs(float(ref))
    assert max_rel(c.grad, gc) <= TOL and max_rel(col.grad, gcol) <= TOL
    # the vertices off the frame get no gradient on either side
    assert float(c.grad[0, :5].abs().max()) == 0.0 == float(jnp.abs(gc[0, :5]).max())


def test_photometric_loss_masks_uncovered_pixels():
    rng = np.random.RandomState(2)
    rgb, tgt = rng.rand(2, 8, 8, 3).astype(np.float32), rng.rand(2, 8, 8, 3).astype(np.float32)
    w = rng.rand(2, 8, 8).astype(np.float32) * 0.1
    ref = J.photometric_loss(rgb, w, tgt)
    got = P.photometric_loss(*(torch.as_tensor(x) for x in (rgb, w, tgt)))
    assert abs(float(got) - float(ref)) <= TOL * abs(float(ref))
    zero = P.photometric_loss(*(torch.as_tensor(x) for x in (rgb, w * 0, tgt)))
    assert float(zero) == 0.0  # nothing covered: the mask's sum is floored at 1


def test_downsample_frames_is_the_jax_box_average():
    frames = np.random.RandomState(3).rand(2, 12, 16, 3).astype(np.float32)
    np.testing.assert_array_equal(P.downsample_frames(frames, 4), J.downsample_frames(frames, 4))


def test_scatters_run_on_the_k1_k8_pair_at_named_sites(scene, monkeypatch):
    """On the CPU both sums go through ``launch_scatter_add_rows`` (its
    plain version) with their site labels, and their backward through
    ``launch_gather_rows``; the wrappers count no kernel launch here."""
    seen = []
    real_s, real_g = scatter_mod.launch_scatter_add_rows, scatter_mod.launch_gather_rows

    def spy(real, kind):
        def call(*args):
            import sys

            # the updates of a scatter, the table of a gather
            shape = tuple(args[1 if kind == "scatter" else 0].shape)
            seen.append((kind, sys._getframe(1).f_locals.get("site"), shape))
            return real(*args)
        return call

    monkeypatch.setattr(scatter_mod, "launch_scatter_add_rows", spy(real_s, "scatter"))
    monkeypatch.setattr(scatter_mod, "launch_gather_rows", spy(real_g, "gather"))
    launches = dict(scatter_mod.LAUNCHES)
    c = torch.tensor(scene["cam"], requires_grad=True)
    normals = P.vertex_normals(c, scene["pb"].tris)
    colors = torch.as_tensor(scene["colors"]) * (1 + normals)
    rgb, w = _render_port(c, colors)
    P.photometric_loss(rgb, w, torch.as_tensor(scene["target"])).backward()
    V, F3 = scene["cam"].shape[1], 3 * scene["b"]["tris"].shape[0]
    assert ("scatter", ("datagen", "normals"), (T * F3, 3)) in seen
    assert ("scatter", ("datagen", "splat"), (4 * T * V, 4)) in seen
    assert ("gather", ("datagen", "normals"), (T * V, 3)) in seen
    assert ("gather", ("datagen", "splat"), (T * (H // SCALE) * (W // SCALE), 4)) in seen
    assert len(seen) == 4
    assert dict(scatter_mod.LAUNCHES) == launches
