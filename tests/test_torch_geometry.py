"""The port's geometry utilities (``ops/geometry.py``) against the JAX
package's: the bounding-sphere coordinates, the sRGB pair, the dense field
sampling and the marching-tetrahedra mesh of a vanilla NeRF's density.

Tolerances: elementwise functions within 1e-6 of max |ref| (the two
frameworks' ``atan2``/``pow`` differ in the last bit); the mesh of a field
exactly equal on both sides bit for bit; the mesh of a NeRF density field
(the same model in both packages) with the same triangle count and sorted
vertices within 1e-4 of JAX's (a box of side 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from geneface_tpu.models.nerf import Lm3dNeRF as JLm3d
from geneface_tpu.ops import geometry as jgeo
from geneface_tpu_torch.convert import nerf_flax_to_state_dict
from geneface_tpu_torch.models.nerf import Lm3dNeRF
from geneface_tpu_torch.ops import geometry as tgeo

torch.set_num_threads(1)


def close(got, ref, bound):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= bound * max(np.abs(ref).max(), 1e-30)


def test_sph_and_srgb_match_jax():
    rng = np.random.RandomState(0)
    o = (rng.randn(256, 3) * 0.3).astype(np.float32)
    d = rng.randn(256, 3).astype(np.float32)
    close(tgeo.sph_from_ray(torch.as_tensor(o), torch.as_tensor(d), 2.0).numpy(),
          jgeo.sph_from_ray(jnp.asarray(o), jnp.asarray(d), 2.0), 1e-6)
    x = rng.uniform(0, 1, 512).astype(np.float32)
    x[:8] = rng.uniform(0, 0.003, 8)
    close(tgeo.linear_to_srgb(torch.as_tensor(x)).numpy(), jgeo.linear_to_srgb(jnp.asarray(x)),
          1e-6)
    close(tgeo.srgb_to_linear(torch.as_tensor(x)).numpy(), jgeo.srgb_to_linear(jnp.asarray(x)),
          1e-6)


def test_marching_tetrahedra_matches_jax():
    g = np.linspace(-1, 1, 12, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    u = 0.7 - np.sqrt(x**2 + (1.3 * y) ** 2 + z**2)
    v, f = tgeo.marching_tetrahedra(u, 0.0)
    jv, jf = jgeo.marching_tetrahedra(u, 0.0)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    assert len(f) > 100
    empty = tgeo.marching_tetrahedra(np.zeros((4, 4, 4), np.float32), 1.0)
    assert empty[0].shape == (0, 3) and empty[1].shape == (0, 3)


def test_extract_geometry_of_a_nerf_density_matches_jax():
    """The fine field's sigma at a condition feature, on a 24³ grid, the
    port's field on the CPU in chunks of 4,096 points."""
    rng = np.random.RandomState(1)
    jm = JLm3d(cond_dim=8, hidden_size=16, smo_win_size=3)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((3, 1, 204)), jnp.zeros((4, 8, 3)),
                     jnp.zeros((4, 3)), method=jm.init_all)
    tm = Lm3dNeRF(204, cond_dim=8, hidden_size=16, smo_win_size=3)
    tm.load_state_dict({k: torch.as_tensor(v) for k, v in nerf_flax_to_state_dict(params).items()})
    feat = rng.randn(8).astype(np.float32)
    view = np.array([[0.0, 0.0, -1.0]], np.float32)

    def jq(p):
        return jm.apply(params, p[:, None, :], jnp.asarray(feat),
                        jnp.broadcast_to(jnp.asarray(view), p.shape), True)[:, 0, 3]

    def tq(p):
        return tm(p[:, None, :], torch.as_tensor(feat), torch.as_tensor(view).expand(p.shape),
                  True)[:, 0, 3]

    lo, hi = (-0.5, -0.5, -0.5), (0.5, 0.5, 0.5)
    ju = jgeo.extract_fields(lo, hi, 24, jq)
    tu = tgeo.extract_fields(lo, hi, 24, tq, chunk=4096, device="cpu")
    close(tu, ju, 1e-5)
    thr = float(np.median(ju))
    jv, jf = jgeo.extract_geometry(lo, hi, 24, thr, jq)
    tv, tf = tgeo.extract_geometry(lo, hi, 24, thr, tq, device="cpu")
    assert len(tf) == len(jf) > 0
    assert np.abs(np.sort(tv, 0) - np.sort(jv, 0)).max() <= 1e-4
