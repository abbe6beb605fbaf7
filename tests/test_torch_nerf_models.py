"""The port's vanilla NeRF models against the JAX package's, parameters
carried across by ``convert.nerf_flax_to_state_dict``: the backbone with the
condition as ``[C]``, ``[1, C]`` and ``[N, C]``, the condition encoders of
``Lm3dNeRF`` (window with and without attention, and the MLP branch),
``ADNeRF`` and ``ADNeRFTorso`` (with and without the colour encoder), the
conversion both ways, and one field's gradient.

Tolerances: forwards within 1e-5 of max |ref|; gradients within a relative
L2 error of 1e-4 (float32 products summed in another order). Positions are
fed as the same float32 arrays on both sides, so the 2⁹ frequency band sees
the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneface_tpu.models.nerf import ADNeRF as JADNeRF
from geneface_tpu.models.nerf import ADNeRFTorso as JTorso
from geneface_tpu.models.nerf import Lm3dNeRF as JLm3d
from geneface_tpu_torch.convert import nerf_flax_to_state_dict, nerf_state_dict_to_flax
from geneface_tpu_torch.models.nerf import ADNeRF, ADNeRFTorso, Lm3dNeRF

torch.set_num_threads(1)

FWD = 1e-5
GRAD = 1e-4


def close(got, ref, bound=FWD):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= bound * scale, np.abs(got - ref).max() / scale


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def pair(jmodel, tmodel, cond, seed=0):
    """JAX-initialised parameters (biases set non-zero) in both models."""
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(cond), jnp.zeros((4, 8, 3)),
                         jnp.zeros((4, 3)), method=jmodel.init_all)
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda v: np.array(v) + (0.05 * rng.randn(*v.shape).astype(np.float32)
                                 if v.ndim == 1 else 0), params)
    tmodel.load_state_dict({k: torch.as_tensor(v)
                            for k, v in nerf_flax_to_state_dict(params).items()})
    return params


def inputs(rng, N=6, S=5):
    pos = rng.uniform(-0.6, 0.6, (N, S, 3)).astype(np.float32)
    view = rng.randn(N, 3).astype(np.float32)
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    return pos, view


@pytest.mark.parametrize("with_att", [True, False], ids=["attention", "window_only"])
def test_lm3d_nerf_matches_jax(with_att):
    rng = np.random.RandomState(0)
    jm = JLm3d(cond_dim=16, hidden_size=32, smo_win_size=5)
    tm = Lm3dNeRF(204, cond_dim=16, hidden_size=32, smo_win_size=5)
    cond = rng.randn(5, 1, 204).astype(np.float32)
    params = pair(jm, tm, cond)
    jf = jm.apply(params, jnp.asarray(cond if with_att else cond[:1]), with_att,
                  method=jm.cal_cond_feat)
    tf = tm.cal_cond_feat(torch.as_tensor(cond if with_att else cond[:1]), with_att)
    close(tf.detach().numpy(), jf)
    pos, view = inputs(rng)
    for fine in (False, True):
        ref = jm.apply(params, jnp.asarray(pos), jf, jnp.asarray(view), fine)
        got = tm(torch.as_tensor(pos), tf, torch.as_tensor(view), fine)
        close(got.detach().numpy(), ref)


def test_lm3d_nerf_mlp_branch_matches_jax():
    """``use_window_cond: false``: the 32-32-64-cond MLP, leaky slope 0.02."""
    rng = np.random.RandomState(1)
    jm = JLm3d(cond_dim=16, hidden_size=32, use_window_cond=False)
    tm = Lm3dNeRF(204, cond_dim=16, hidden_size=32, use_window_cond=False)
    cond = rng.randn(1, 204).astype(np.float32)
    params = pair(jm, tm, cond)
    jf = jm.apply(params, jnp.asarray(cond), False, method=jm.cal_cond_feat)
    tf = tm.cal_cond_feat(torch.as_tensor(cond), False)
    close(tf.detach().numpy(), jf)
    pos, view = inputs(rng)
    close(tm(torch.as_tensor(pos), tf, torch.as_tensor(view), True).detach().numpy(),
          jm.apply(params, jnp.asarray(pos), jf, jnp.asarray(view), True))


@pytest.mark.parametrize("cond_shape", ["vector", "row", "per_ray"])
def test_backbone_broadcasts_condition_like_jax(cond_shape):
    """The condition as ``[C]`` (the attention path), ``[1, C]`` (the warm
    start) and ``[N, C]``."""
    rng = np.random.RandomState(2)
    jm = JADNeRF(cond_dim=16, hidden_size=32)
    tm = ADNeRF(29, cond_dim=16, hidden_size=32)
    params = pair(jm, tm, rng.randn(8, 16, 29).astype(np.float32))
    pos, view = inputs(rng)
    feat = {"vector": rng.randn(16), "row": rng.randn(1, 16),
            "per_ray": rng.randn(pos.shape[0], 16)}[cond_shape].astype(np.float32)
    ref = jm.apply(params, jnp.asarray(pos), jnp.asarray(feat), jnp.asarray(view), False)
    got = tm(torch.as_tensor(pos), torch.as_tensor(feat), torch.as_tensor(view), False)
    close(got.detach().numpy(), ref)


def test_adnerf_condition_matches_jax():
    rng = np.random.RandomState(3)
    jm = JADNeRF(cond_dim=16, hidden_size=32)
    tm = ADNeRF(29, cond_dim=16, hidden_size=32)
    cond = rng.randn(8, 16, 29).astype(np.float32)
    params = pair(jm, tm, cond)
    for att in (True, False):
        c = cond if att else cond[:1]
        close(tm.cal_cond_feat(torch.as_tensor(c), att).detach().numpy(),
              jm.apply(params, jnp.asarray(c), att, method=jm.cal_cond_feat))


@pytest.mark.parametrize("use_color", [True, False], ids=["color", "no_color"])
def test_adnerf_torso_matches_jax(use_color):
    """The torso condition (window feature, euler and translation at 6
    bands, the head colour through 16-32-16) and the torso field."""
    rng = np.random.RandomState(4)
    jm = JTorso(cond_dim=16, hidden_size=32, use_color=use_color, cond_win_size=1,
                smo_win_size=5)
    tm = ADNeRFTorso(204, cond_dim=16, hidden_size=32, use_color=use_color, cond_win_size=1,
                     smo_win_size=5)
    cond = rng.randn(5, 1, 204).astype(np.float32)
    params = pair(jm, tm, cond)
    euler, trans = rng.randn(3).astype(np.float32), rng.randn(3).astype(np.float32)
    pos, view = inputs(rng)
    color = rng.rand(pos.shape[0], 3).astype(np.float32) if use_color else None
    jf = jm.apply(params, jnp.asarray(cond), jnp.asarray(euler), jnp.asarray(trans),
                  None if color is None else jnp.asarray(color), True, method=jm.cal_cond_feat)
    tf = tm.cal_cond_feat(torch.as_tensor(cond), torch.as_tensor(euler), torch.as_tensor(trans),
                          None if color is None else torch.as_tensor(color), True)
    close(tf.detach().numpy(), jf)
    close(tm(torch.as_tensor(pos), tf, torch.as_tensor(view), True).detach().numpy(),
          jm.apply(params, jnp.asarray(pos), jf, jnp.asarray(view), True))


def test_conversion_round_trips_the_jax_tree():
    """JAX tree → port → JAX tree, leaf for leaf, for every family."""
    cases = [
        (JLm3d(cond_dim=8, hidden_size=16), np.zeros((5, 1, 204), np.float32)),
        (JLm3d(cond_dim=8, hidden_size=16, use_window_cond=False), np.zeros((1, 204),
                                                                            np.float32)),
        (JADNeRF(cond_dim=8, hidden_size=16), np.zeros((8, 16, 29), np.float32)),
        (JTorso(cond_dim=8, hidden_size=16, use_color=True), np.zeros((8, 16, 29), np.float32)),
    ]
    tmodels = [Lm3dNeRF(204, 8, 16), Lm3dNeRF(204, 8, 16, use_window_cond=False),
               ADNeRF(29, 8, 16), ADNeRFTorso(29, 8, 16, use_color=True)]
    for (jm, cond), tm in zip(cases, tmodels):
        params = pair(jm, tm, cond)
        back = nerf_state_dict_to_flax(tm.state_dict())
        flat = jax.tree_util.tree_leaves_with_path(params)
        assert len(flat) == len(jax.tree_util.tree_leaves(back))
        for path, leaf in flat:
            node = back
            for k in path:
                node = node[k.key]
            np.testing.assert_array_equal(node, leaf)


def test_field_gradient_matches_jax():
    """d(sum of a weighted raw)/d(parameters) of the fine field with the
    attention condition, every leaf within 1e-4 relative L2."""
    rng = np.random.RandomState(5)
    jm = JLm3d(cond_dim=16, hidden_size=32, smo_win_size=5)
    tm = Lm3dNeRF(204, cond_dim=16, hidden_size=32, smo_win_size=5)
    cond = rng.randn(5, 1, 204).astype(np.float32)
    params = pair(jm, tm, cond)
    pos, view = inputs(rng)
    wts = rng.randn(*pos.shape[:2], 4).astype(np.float32)

    def jloss(p):
        f = jm.apply(p, jnp.asarray(cond), True, method=jm.cal_cond_feat)
        return jnp.sum(jm.apply(p, jnp.asarray(pos), f, jnp.asarray(view), True) * wts)

    jg = jax.grad(jloss)(params)
    f = tm.cal_cond_feat(torch.as_tensor(cond), True)
    (tm(torch.as_tensor(pos), f, torch.as_tensor(view), True) * torch.as_tensor(wts)).sum().backward()
    grads = nerf_state_dict_to_flax({n: p.grad for n, p in tm.named_parameters()
                                     if p.grad is not None})
    for path, leaf in jax.tree_util.tree_leaves_with_path(jg):
        if "model_coarse" in str(path):
            continue  # the coarse net is not in this loss
        node = grads
        for k in path:
            node = node[k.key]
        assert rel_l2(node, leaf) < GRAD, (path, rel_l2(node, leaf))


def test_backbone_importer_matches_jax():
    """``utils/torch_import.py::nerf_backbone_params_from_torch`` on a
    seeded GeneFace ``NeRFBackbone`` state dict (``density_linears.<i>``,
    ``density_out_linear``, ``color_linears.<i>``, ``color_out_linear``,
    under a ``model_fine.`` prefix): the same tree as the JAX importer's,
    and the port's backbone holding it matches the JAX one's forward."""
    from geneface_tpu.models.nerf.backbone import NeRFBackbone as JBackbone
    from geneface_tpu.utils import torch_import as j_import
    from geneface_tpu_torch.models.nerf import NeRFBackbone
    from geneface_tpu_torch.utils import torch_import

    rng = np.random.RandomState(9)
    pos = rng.randn(3, 4, 63).astype(np.float32)
    cond = rng.randn(16).astype(np.float32)
    view = rng.randn(3, 27).astype(np.float32)
    jb = JBackbone(hid_dim=32)
    jtemplate = jb.init(jax.random.PRNGKey(0), jnp.asarray(pos), jnp.asarray(cond),
                        jnp.asarray(view))
    tb = NeRFBackbone(63 + 16, 27, hid_dim=32)
    names = ([f"density_linears.{i}" for i in range(8)] + ["density_out_linear"]
             + [f"color_linears.{i}" for i in range(3)] + ["color_out_linear"])
    sd = {}
    for i, name in enumerate(names):
        w = tb.layers[i].weight
        sd[f"model_fine.{name}.weight"] = rng.randn(*w.shape).astype(np.float32) * 0.2
        sd[f"model_fine.{name}.bias"] = rng.randn(w.shape[0]).astype(np.float32) * 0.2
    sd["model_fine.unrelated"] = np.zeros(3, np.float32)  # other keys are ignored
    template = {"params": nerf_state_dict_to_flax(
        {f"model_fine.{k}": v for k, v in tb.state_dict().items()})["params"]["model_fine"]}
    got = torch_import.nerf_backbone_params_from_torch(sd, template, prefix_t="model_fine.")
    ref = j_import.nerf_backbone_params_from_torch(sd, jtemplate, prefix_t="model_fine.")
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    got_l, ref_l = flat(got), flat(ref)
    assert sorted(got_l) == sorted(ref_l) and len(got_l) == 26
    for k in ref_l:
        assert got_l[k].dtype == np.float32
        np.testing.assert_array_equal(got_l[k], ref_l[k])
    loaded = nerf_flax_to_state_dict({"model_fine": got["params"]})
    tb.load_state_dict({k.split(".", 1)[1]: torch.as_tensor(v) for k, v in loaded.items()})
    close(tb(torch.as_tensor(pos), torch.as_tensor(cond), torch.as_tensor(view)).detach().numpy(),
          jb.apply(ref, jnp.asarray(pos), jnp.asarray(cond), jnp.asarray(view)))
    with pytest.raises(ValueError, match="shape mismatch"):
        bad = dict(sd, **{"model_fine.color_out_linear.weight": np.zeros((3, 5), np.float32)})
        torch_import.nerf_backbone_params_from_torch(bad, template, prefix_t="model_fine.")
