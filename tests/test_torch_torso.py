"""The port's torso pieces against the JAX package: the frequency encoding,
``forward_torso`` (head-aware off and on), the 2-D torso occupancy (sample,
mask, sweep), the walk ``march_rays_train`` (both branches), the slab
``composite_rays``, the parameter conversion and the partial restore.

Both sides get the same parameters (the JAX init, converted) and the same
numpy inputs; noise is drawn in JAX as the JAX renderer draws it and handed
to the port. Tolerances:
- ``freq_encode``: atol 1e-6 (at degree 10 the argument reaches 2⁹·x and
  the two libraries' ``sin`` may differ by an ulp of the result);
- ``forward_torso`` at float32: alpha and colour atol 1e-5, the offset atol
  1e-6 (two small MLPs and a grid; sums in another order);
- the torso occupancy: the bilinear sample rtol 1e-6, the mask equal
  wherever the sample is further than 1e-6 from the threshold, the sweep's
  grid and mean rtol 1e-6;
- the walk: the same ``valid`` mask, and ``ts``/``dts``/``depth_ts`` within
  1e-6 (both round ``o + t·d`` and ``t + k·dt`` once);
- ``composite_rays``: rtol 1e-6, atol 1e-6; the inclusion mask exact;
- conversion and partial restore: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneface_tpu.config import Config as JConfig
from geneface_tpu.models.radnerf import RADNeRFTorso as JTorso
from geneface_tpu.models.radnerf import renderer as jrend
from geneface_tpu.models.radnerf.radnerf_torso import sample_torso_occupancy as jsample
from geneface_tpu.ops import encoders as jenc
from geneface_tpu.ops import raymarch as jrm
from geneface_tpu.tasks.radnerf import model_from_cfg as jmodel_from_cfg
from geneface_tpu.utils.checkpoint import restore_partial as jrestore_partial
from geneface_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from geneface_tpu_torch.models.radnerf import (
    TorsoOccupancyState,
    model_from_cfg,
    sample_torso_occupancy,
    torso_occupancy_mask,
    update_torso_occupancy,
)
from geneface_tpu_torch.ops import (
    composite_rays,
    freq_encode,
    freq_encode_output_dim,
    march_rays_train,
    near_far_from_aabb,
)
from geneface_tpu_torch.utils.checkpoint import restore_partial

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)

CFG = dict(
    cond_type="idexp_lm3d_normalized", cond_win_size=1, smo_win_size=3,
    cond_out_dim=16, with_att=True, bound=1, grid_type="tiledgrid",
    log2_hashmap_size=14, desired_resolution=128, grid_size=32,
    num_layers_ambient=2, hidden_dim_ambient=16, num_layers_sigma=2,
    hidden_dim_sigma=16, geo_feat_dim=16, num_layers_color=2,
    hidden_dim_color=16, individual_embedding_num=16,
    individual_embedding_dim=4, max_steps=8, min_near=0.05,
)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "head_aware"])
def torso_pair(request):
    """The JAX torso model, its init and the port's model on it."""
    cfg = {**CFG, "torso_head_aware": request.param}
    jmodel = jmodel_from_cfg(JConfig(cfg), JTorso, dtype=jnp.float32,
                             torso_head_aware=request.param)
    params = jax.jit(lambda key: jmodel.init(
        key, jnp.zeros((3, 1, 204)), jnp.zeros((8, 3)), jnp.zeros((8, 3)),
        method=jmodel.init_all,
    ))(jax.random.PRNGKey(0))
    model = model_from_cfg(cfg, torso=True, dtype=torch.float32)
    model.load_state_dict({k: _t(v) for k, v in flax_to_state_dict(params).items()})
    return jmodel, params, model


# ---------------------------------------------------------------- encoding --
@pytest.mark.parametrize("D,degree", [(2, 10), (6, 4), (3, 1)])
def test_freq_encode_matches(D, degree):
    x = np.random.RandomState(D).uniform(-1, 1, (700, D)).astype(np.float32)
    ref = np.asarray(jenc.freq_encode(jnp.asarray(x), degree))
    got = freq_encode(_t(x), degree).numpy()
    assert got.shape == ref.shape == (700, freq_encode_output_dim(D, degree))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


# ------------------------------------------------------------------ model --
def test_forward_torso_matches(torso_pair):
    jmodel, params, model = torso_pair
    rng = np.random.RandomState(1)
    N = 3000
    x = rng.uniform(-1.1, 1.1, (N, 2)).astype(np.float32)
    pose = (rng.randn(1, 6) * 0.3).astype(np.float32)
    head_img = rng.rand(N, 3).astype(np.float32)
    head_ws = rng.rand(N, 1).astype(np.float32)
    ind = np.asarray(params["params"]["torso_individual_codes"][3])
    want = jax.jit(lambda *a: jmodel.apply(params, *a, method=jmodel.forward_torso))(
        jnp.asarray(x), jnp.asarray(pose), jnp.asarray(ind), jnp.asarray(head_img),
        jnp.asarray(head_ws),
    )
    got = model.forward_torso(_t(x), _t(pose), _t(ind), _t(head_img), _t(head_ws))
    for g, w, atol in zip(got, want, (1e-5, 1e-5, 1e-6)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=atol)
    # the torso grid keeps its own full-width geometry in a tiny head config
    shapes = [tuple(t.shape) for t in model.torso_grid_tables()]
    assert shapes == [(324, 16), (5466, 112)]


def test_conversion_round_trip_of_a_jax_torso_tree(torso_pair):
    _, params, model = torso_pair
    back = state_dict_to_flax(model.state_dict())
    flat = dict(jax.tree_util.tree_leaves_with_path(params))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert flat.keys() == flat_back.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(flat_back[k], np.asarray(v), err_msg=str(k))


def test_restore_partial_matches_jax(torso_pair):
    _, params, model = torso_pair
    target = state_dict_to_flax(model.state_dict())["params"]
    rng = np.random.RandomState(2)
    source = jax.tree_util.tree_map(
        lambda v: rng.randn(*np.shape(v)).astype(np.float32), dict(params["params"])
    )
    source = {k: v for k, v in source.items() if "torso" not in k}  # a head checkpoint
    source["sigma_net"] = {"Dense_0": {"kernel": np.zeros((3, 3), np.float32)}}  # wrong shape
    want = jrestore_partial(target, source, silent=True)
    got = restore_partial(target, source, silent=True)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert flat_w.keys() == flat_g.keys()
    for k, v in flat_w.items():
        np.testing.assert_array_equal(flat_g[k], v, err_msg=str(k))
    np.testing.assert_array_equal(got["color_net"]["Dense_0"]["kernel"],
                                  source["color_net"]["Dense_0"]["kernel"])
    np.testing.assert_array_equal(got["sigma_net"]["Dense_0"]["kernel"],
                                  target["sigma_net"]["Dense_0"]["kernel"])


# -------------------------------------------------------- torso occupancy --
def test_torso_occupancy_sample_mask_and_sweep():
    H = 32
    rng = np.random.RandomState(3)
    grid = (rng.rand(H * H) * 0.02).astype(np.float32)
    coords = rng.uniform(-1, 1, (5000, 2)).astype(np.float32)
    want = np.asarray(jsample(jnp.asarray(grid), jnp.asarray(coords), H))
    got = sample_torso_occupancy(_t(grid), _t(coords), H).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)

    jocc = jrend.TorsoOccupancyState(jnp.asarray(grid), jnp.asarray(grid.mean()))
    tocc = TorsoOccupancyState(_t(grid), torch.tensor(grid.mean()))
    thresh = min(0.01, float(grid.mean()))
    jmask = np.asarray(jrend.torso_occupancy_mask(jocc, jnp.asarray(coords), H, 0.01))
    tmask = torso_occupancy_mask(tocc, _t(coords), H, 0.01).numpy()
    away = np.abs(want - thresh) > 1e-6
    np.testing.assert_array_equal(tmask[away], jmask[away])
    assert 0 < tmask.sum() < len(tmask)

    # two sweeps of an alpha field off-centre: the EMA and the transpose
    def alpha_j(xy):
        return jax.nn.sigmoid(8.0 * (xy[:, 0] - 0.5 * xy[:, 1]))

    def alpha_t(xy):
        return torch.sigmoid(8.0 * (xy[:, 0] - 0.5 * xy[:, 1]))

    key = jax.random.PRNGKey(5)
    for _ in range(2):
        jocc = jrend.update_torso_occupancy(alpha_j, jocc, key, grid_size=H)
        jitter = _t(jax.random.uniform(key, (H * H, 2)))  # as renderer.py:680 draws it
        tocc = update_torso_occupancy(alpha_t, tocc, jitter, grid_size=H)
        key = jax.random.fold_in(key, 1)
    np.testing.assert_allclose(tocc.density_grid.numpy(), np.asarray(jocc.density_grid),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(tocc.mean_density), float(jocc.mean_density), rtol=1e-6)


# ------------------------------------------------------------------- walk --
def _walk_scene(S, seed):
    """A seeded 32³ grid (a ball plus scattered cells) and rays from a
    camera in front of it."""
    H = 32
    rng = np.random.RandomState(seed)
    occ = rng.rand(1, H, H, H) < 0.05
    r = (np.arange(H) + 0.5) / H * 2 - 1
    gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
    occ[0] |= np.sqrt(gx**2 + gy**2 + gz**2) < 0.6
    N = 3000
    ro = np.array([[0.0, 0.0, 2.5]], np.float32) + rng.randn(N, 3).astype(np.float32) * 0.1
    rd = rng.uniform(-0.8, 0.8, (N, 3)).astype(np.float32) - ro
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return H, occ, ro, rd, rng.rand(N).astype(np.float32)


@pytest.mark.parametrize("branch,S,dt_gamma", [("uniform", 8, 1 / 256), ("general", 48, 1 / 16)])
def test_walk_matches_jax(branch, S, dt_gamma):
    H, occ, ro, rd, noises = _walk_scene(S, seed=S)
    aabb = jrend.make_aabb(1.0)
    jn, jf = jrm.near_far_from_aabb(jnp.asarray(ro), jnp.asarray(rd), aabb, 0.05)
    want = jrm.march_rays_train(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(occ), jn, jf, jnp.asarray(noises),
        bound=1.0, dt_gamma=dt_gamma, max_steps=S, cascade=1, grid_size=H,
    )
    tn, tf = near_far_from_aabb(_t(ro), _t(rd), _t(aabb), 0.05)
    got = march_rays_train(_t(ro), _t(rd), _t(occ), tn, tf, _t(noises),
                           bound=1.0, dt_gamma=dt_gamma, max_steps=S, grid_size=H)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    n = valid.sum(-1)
    assert n.mean() > 1.5 and n.max() >= 8  # many samples, long runs of them
    for k in ("ts", "dts", "depth_ts"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=0, atol=1e-6, err_msg=k)
    if branch == "general":  # the step really varies along the rays
        d = got.dts.numpy()[valid]
        assert d.min() < d.max()


def test_walk_refuses_cascades():
    occ = torch.zeros(2, 8, 8, 8, dtype=torch.bool)
    z = torch.zeros(4)
    with pytest.raises(NotImplementedError):
        march_rays_train(torch.zeros(4, 3), torch.ones(4, 3), occ, z, z, z, grid_size=8)


def test_composite_rays_matches_jax():
    rng = np.random.RandomState(4)
    N, S = 500, 16
    sig = (rng.rand(N, S) * 30).astype(np.float32)
    rgb = rng.rand(N, S, 3).astype(np.float32)
    dts = np.full((N, S), 0.03, np.float32)
    dep = np.cumsum(dts, -1) + 1.0
    n = rng.randint(0, S + 1, N)
    valid = np.arange(S)[None] < n[:, None]
    amb = rng.rand(N, S).astype(np.float32)
    want = jrm.composite_rays(
        jnp.asarray(sig), jnp.asarray(rgb.transpose(2, 0, 1)), jnp.asarray(dts),
        jnp.asarray(dep), jnp.asarray(valid), ambients=jnp.asarray(amb),
    )
    got = composite_rays(_t(sig), _t(rgb), _t(dts), _t(dep), _t(valid), ambients=_t(amb))
    np.testing.assert_array_equal(got["weights"].numpy() > 0, np.asarray(want["weights"]) > 0)
    assert (np.asarray(want["weights"]) == 0).any() and (np.asarray(want["weights"]) > 0).any()
    for k in ("image", "weights_sum", "depth", "ambient_sum", "weights"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
