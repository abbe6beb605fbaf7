"""The port's RAD-NeRF field and checkpoint IO against the JAX model.

Both sides get the same parameters (the JAX init, converted) and the same
numpy inputs. Tolerances: float32 — rtol 1e-5 / atol 1e-6 (sums in another
order); bf16 MLPs — atol 1e-3 on log-sigma, colours and ambient
coordinates (both sides round the same products once; the margin is for a
hidden unit that rounds the other way, 2^-8 relative).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneface_tpu.config import Config as JConfig
from geneface_tpu.models.radnerf import RADNeRF as JRADNeRF
from geneface_tpu.models.radnerf.renderer import OccupancyState as JOcc
from geneface_tpu.tasks.radnerf import model_from_cfg as jmodel_from_cfg
from geneface_tpu.utils.checkpoint import save_checkpoint as jsave
from geneface_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from geneface_tpu_torch.models.radnerf import OccupancyState, model_from_cfg
from geneface_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.make_synthetic_dataset import make_dataset  # noqa: E402

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


def _jax_params(jmodel, seed=0):
    cond = jnp.zeros((CFG["smo_win_size"], 1, 204))
    return jmodel.init(
        jax.random.PRNGKey(seed), cond, jnp.zeros((8, 3)), jnp.zeros((8, 3)),
        method=jmodel.init_all,
    )


def _port_model(params, dtype, **over):
    model = model_from_cfg({**CFG, **over}, dtype=dtype)
    sd = {k: torch.from_numpy(v) for k, v in flax_to_state_dict(params).items()}
    model.load_state_dict(sd)
    return model.eval()


def _inputs(M=2000, seed=1):
    rng = np.random.RandomState(seed)
    cond = rng.randn(CFG["smo_win_size"], 1, 204).astype(np.float32)
    xyz = rng.uniform(-1, 1, size=(M, 3)).astype(np.float32)
    d = rng.randn(M, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return cond, xyz, d


def _both(jdtype, tdtype, **over):
    jmodel = jmodel_from_cfg(JConfig({**CFG, **over}), JRADNeRF, dtype=jdtype)
    params = _jax_params(jmodel)
    # non-zero biases so the conversion of every Dense/Conv bias is checked
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.05 if jax.tree_util.keystr(p).endswith("['bias']") else v,
        params,
    )
    return jmodel, params, _port_model(params, tdtype, **over)


@pytest.mark.parametrize("ungroup", [0, 4])
def test_field_matches_f32(ungroup):
    jmodel, params, model = _both(jnp.float32, torch.float32, fused_ungroup_coarse=ungroup)
    cond, xyz, d = _inputs()
    jfeat = jmodel.apply(params, jnp.asarray(cond), method=jmodel.cal_cond_feat)
    ind = params["params"]["individual_embeddings"][3]
    js, jc, ja = jmodel.apply(params, jnp.asarray(xyz), jnp.asarray(d), jfeat, ind)
    with torch.no_grad():
        feat = model.cal_cond_feat(torch.from_numpy(cond))
        np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), rtol=1e-5, atol=1e-6)
        s, c, a = model(
            torch.from_numpy(xyz), torch.from_numpy(d), feat,
            model.individual_embeddings[3],
        )
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)
    sj = jmodel.apply(params, jnp.asarray(xyz), jfeat, method=jmodel.density)["sigma"]
    with torch.no_grad():
        st = model.density(torch.from_numpy(xyz), feat)["sigma"]
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5, atol=1e-6)


def test_field_matches_bf16():
    jmodel, params, model = _both(jnp.bfloat16, torch.bfloat16)
    cond, xyz, d = _inputs(seed=2)
    jfeat = jmodel.apply(params, jnp.asarray(cond), method=jmodel.cal_cond_feat)
    ind = params["params"]["individual_embeddings"][0]
    js, jc, ja = jmodel.apply(params, jnp.asarray(xyz), jnp.asarray(d), jfeat, ind)
    with torch.no_grad():
        feat = model.cal_cond_feat(torch.from_numpy(cond))
        s, c, a = model(
            torch.from_numpy(xyz), torch.from_numpy(d), feat, model.individual_embeddings[0]
        )
    np.testing.assert_allclose(np.log(s.numpy()), np.log(np.asarray(js)), atol=1e-3)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-3)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=1e-3)
    # almost every value agrees to float32 rounding: flips are rare
    assert np.mean(np.abs(c.numpy() - np.asarray(jc)) < 1e-5) > 0.99


def test_state_dict_round_trip():
    _, params, model = _both(jnp.float32, torch.float32)
    back = state_dict_to_flax(model.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, v in flat_a:
        np.testing.assert_array_equal(flat_b[path], np.asarray(v))


def _planted_occ(H):
    r = (np.arange(H) + 0.5) / H * 2.0 - 1.0
    gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
    occ = np.sqrt(gx**2 + gy**2 + gz**2) < 0.6
    return occ, np.where(occ, 40.0, 0.0).reshape(1, -1).astype(np.float32)


def test_jax_checkpoint_loads_in_port(tmp_path):
    """A JAX checkpoint pickles the OccupancyState NamedTuple; the port's
    restricted unpickler maps it without importing the JAX package."""
    jmodel = jmodel_from_cfg(JConfig(CFG), JRADNeRF, dtype=jnp.float32)
    params = _jax_params(jmodel)
    occ, dens = _planted_occ(CFG["grid_size"])
    state = {"params": params,
             "occ": JOcc(jnp.asarray(dens), jnp.asarray(occ[None]), jnp.asarray(1.5))}
    path = str(tmp_path / "model_ckpt_steps_7.ckpt")
    jsave(path, {"state": state, "step": 7})
    ck = load_checkpoint(path)
    assert ck["step"] == 7
    assert isinstance(ck["state"]["occ"], OccupancyState)
    np.testing.assert_array_equal(ck["state"]["occ"].occ_grid, occ[None])
    assert float(ck["state"]["occ"].mean_density) == 1.5
    sd = flax_to_state_dict(ck["state"]["params"])
    model = _port_model(params, torch.float32)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(sd[k], v.numpy())


def test_port_checkpoint_loads_in_jax_infer(tmp_path):
    from geneface_tpu.inference.radnerf_infer import RADNeRFInfer as JInfer

    data = tmp_path / "data"
    make_dataset(str(data), n_frames=4, hw=32)
    work = tmp_path / "work"
    model = model_from_cfg(CFG, dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    occ, dens = _planted_occ(CFG["grid_size"])
    save_checkpoint(
        str(work / "model_ckpt_steps_0.ckpt"),
        {"state": {"params": state_dict_to_flax(model.state_dict()),
                   "occ": (dens, occ[None], np.float32(2.0))}, "step": 0},
    )
    jinf = JInfer(JConfig({**CFG, "data_dir": str(data)}), str(work))
    assert not jinf.torso
    np.testing.assert_array_equal(np.asarray(jinf.occ.occ_grid), occ[None])
    got = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jinf.params))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(got[k], v.numpy())


def test_config_chain_matches_jax_loader():
    from geneface_tpu.config import load_config as jload_config
    from geneface_tpu_torch.config import load_config

    path = os.path.join(
        os.path.dirname(__file__), "..", "egs", "datasets", "videos", "May", "lm3d_radnerf.yaml"
    )
    got = load_config(path)
    assert dict(got) == dict(jload_config(path))
    assert got.grid_size == 128 and got["smo_win_size"] == 5
    model = model_from_cfg(got)
    assert model.pos_fused_meta.groups == ((0,), (1, 2, 3, 4, 5, 6, 7))
