"""The port's GeneFace checkpoint importer (``geneface_tpu_torch/utils/
torch_import.py``) against the JAX package's (``geneface_tpu/utils/
torch_import.py``) on the CPU.

Every checkpoint is authored from seeded numpy at the key names and shapes
that the JAX importer reads (the released GeneFace weights are not in the
repository). Both importers convert the same state_dict onto templates of
their own package's module; the trees must be equal leaf for leaf (the
same numpy operations on the same arrays). The imported field is then held
to JAX's field at float32 to 1e-5 of its largest magnitude.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneface_tpu.config import Config as JConfig
from geneface_tpu.models.audio2motion import VAEModel as JVAE
from geneface_tpu.models.postnet.models import CNNPostNet as JPostNet
from geneface_tpu.models.radnerf import RADNeRFTorso as JTorso
from geneface_tpu.tasks.radnerf import model_from_cfg as jmodel_from_cfg
from geneface_tpu.utils import torch_import as jti
from geneface_tpu_torch.convert import flax_to_state_dict, flax_variables, state_dict_to_flax
from geneface_tpu_torch.models.audio2motion.vae import VAEModel
from geneface_tpu_torch.models.postnet.models import CNNPostNet
from geneface_tpu_torch.models.radnerf import model_from_cfg
from geneface_tpu_torch.utils import torch_import as ti
from geneface_tpu_torch.utils.checkpoint import load_checkpoint

CFG = dict(
    cond_type="idexp_lm3d_normalized", cond_out_dim=16, cond_win_size=1, smo_win_size=3,
    with_att=True, bound=1, grid_type="tiledgrid", log2_hashmap_size=12,
    desired_resolution=256, grid_num_levels=16, grid_level_dim=2, grid_backend="reference",
    num_layers_ambient=2, hidden_dim_ambient=16, num_layers_sigma=2, hidden_dim_sigma=16,
    geo_feat_dim=16, num_layers_color=2, hidden_dim_color=16, individual_embedding_num=6,
    individual_embedding_dim=4, grid_size=16, density_thresh=10,
)
TORSO = dict(torso_shrink=0.8, torso_individual_embedding_dim=8, torso_head_aware=False)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def assert_trees_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg="/".join(map(str, k)))


def seeded_reference_sd(torso: bool, seed: int = 0) -> dict:
    """A GeneFace (head or torso) state_dict: a seeded port model exported
    to the reference's names, grids spread to ±0.5, density buffers."""
    model = model_from_cfg(CFG, torso=torso)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    sd = ti.reference_state_dict(model)
    rng = np.random.RandomState(seed)
    for k in sd:
        if k.endswith("embedder.embeddings"):
            sd[k] = rng.uniform(-0.5, 0.5, sd[k].shape).astype(np.float32)
    H = CFG["grid_size"]
    dg = rng.uniform(0, 40, H**3).astype(np.float32)
    dg[rng.rand(H**3) < 0.2] = -1.0  # untrained cells
    sd["density_grid"] = dg
    if torso:
        sd["density_grid_torso"] = rng.uniform(0, 1, H * H).astype(np.float32)
    return sd


def jax_template(torso: bool, backend: str = "reference"):
    cfg = JConfig(dict(CFG, grid_backend=backend, **(TORSO if torso else {})))
    extra = dict(TORSO, dtype=jnp.float32) if torso else dict(dtype=jnp.float32)
    jm = jmodel_from_cfg(cfg, JTorso, **extra) if torso else jmodel_from_cfg(cfg, **extra)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((3, 1, 204)), jnp.zeros((8, 3)),
                     jnp.zeros((8, 3)), method=jm.init_all)
    return jm, params


def port_template(torso: bool, backend: str = "reference"):
    return state_dict_to_flax(model_from_cfg(dict(CFG, grid_backend=backend),
                                             torso=torso).state_dict())


@pytest.fixture(scope="module")
def head_sd():
    return seeded_reference_sd(torso=False)


@pytest.fixture(scope="module")
def torso_sd():
    return seeded_reference_sd(torso=True, seed=1)


@pytest.mark.parametrize("fmt", ["nested", "flat", "directory"])
def test_loader_formats(tmp_path, head_sd, fmt):
    """``{"state_dict": {"model": sd}}``, the flat dotted ``model.<key>``
    format, and a work dir whose newest ``model_ckpt_steps_*`` is read."""
    t = {k: torch.from_numpy(v) for k, v in head_sd.items()}
    if fmt == "nested":
        path = str(tmp_path / "model_ckpt_steps_5.ckpt")
        torch.save({"state_dict": {"model": t}, "optimizer_states": []}, path)
    elif fmt == "flat":
        path = str(tmp_path / "model_ckpt_steps_5.ckpt")
        torch.save({"state_dict": {f"model.{k}": v for k, v in t.items()}}, path)
    else:
        stale = {k: v + 1.0 for k, v in t.items()}
        torch.save({"state_dict": {"model": stale}}, str(tmp_path / "model_ckpt_steps_90.ckpt"))
        torch.save({"state_dict": {"model": t}}, str(tmp_path / "model_ckpt_steps_100.ckpt"))
        path = str(tmp_path)
    got = ti.load_reference_checkpoint(path)
    want = jti.load_reference_checkpoint(path)
    assert sorted(got) == sorted(want) == sorted(head_sd)
    for k in head_sd:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], head_sd[k])


@pytest.mark.parametrize("torso", [False, True], ids=["head", "torso"])
@pytest.mark.parametrize("backend", ["reference", "block"])
def test_radnerf_tree_equals_jax_importer(head_sd, torso_sd, torso, backend):
    sd = torso_sd if torso else head_sd
    _, jtemplate = jax_template(torso, backend)
    want = jax.tree_util.tree_map(np.asarray, jti.radnerf_params_from_torch(sd, jtemplate))
    got = ti.radnerf_params_from_torch(sd, port_template(torso, backend))
    assert_trees_equal(got, want)
    # and the import carries the checkpoint's arrays as they are
    np.testing.assert_array_equal(got["params"]["pos_embeddings"],
                                  sd["position_embedder.embeddings"])
    if torso:
        np.testing.assert_array_equal(got["params"]["torso_canonical_net"]["Dense_0"]["kernel"],
                                      sd["torso_canonicial_net.net.0.weight"].T)


def test_occupancy_and_torso_grid_equal_jax(torso_sd):
    H = CFG["grid_size"]
    got = ti.occupancy_from_torch(torso_sd, H, 10.0)
    want = jti.occupancy_from_torch(torso_sd, H, 10.0)
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert 0 < got.occ_grid.sum() < H**3
    np.testing.assert_array_equal(ti.torso_density_grid_from_torch(torso_sd, H),
                                  jti.torso_density_grid_from_torch(torso_sd, H))


def test_import_into_fused_raises(head_sd):
    with pytest.raises(ValueError, match="fused grid layout") as got:
        ti.radnerf_params_from_torch(head_sd, port_template(False, "fused"))
    jm = jmodel_from_cfg(JConfig(dict(CFG, grid_backend="fused", grid_num_levels=8,
                                      grid_level_dim=4)))
    jp = jm.init(jax.random.PRNGKey(0), jnp.zeros((3, 1, 204)), jnp.zeros((8, 3)),
                 jnp.zeros((8, 3)), method=jm.init_all)
    with pytest.raises(ValueError) as want:
        jti.radnerf_params_from_torch(head_sd, jp)
    assert str(got.value) == str(want.value)


def test_shape_mismatch_names_the_config_keys(head_sd):
    bad = dict(head_sd)
    bad["position_embedder.embeddings"] = bad["position_embedder.embeddings"][:-8]
    with pytest.raises(ValueError, match="grid_num_levels: 16"):
        ti.radnerf_params_from_torch(bad, port_template(False))


@pytest.mark.parametrize("torso", [False, True], ids=["head", "torso"])
def test_imported_field_matches_jax(torso_sd, torso):
    """The converted tree loaded into each package's model (float32 MLPs):
    sigma, color, ambient (and the torso's alpha, color, Δxy) within 1e-5
    of the largest magnitude."""
    jm, jtemplate = jax_template(torso=True)
    jparams = jti.radnerf_params_from_torch(torso_sd, jtemplate)
    tree = ti.radnerf_params_from_torch(torso_sd, port_template(torso=True))
    model = model_from_cfg(CFG, torso=True, dtype=torch.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in flax_to_state_dict(tree).items()})
    rng = np.random.RandomState(3)
    xyz = rng.uniform(-0.95, 0.95, (400, 3)).astype(np.float32)
    d = rng.randn(400, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cond = rng.randn(3, 1, 204).astype(np.float32)
    with torch.no_grad():
        feat = model.cal_cond_feat(torch.from_numpy(cond))
    jfeat = jm.apply(jparams, jnp.asarray(cond), method=jm.cal_cond_feat)
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), rtol=0,
                               atol=1e-5 * float(np.abs(jfeat).max()))
    jfeat = jnp.asarray(feat.numpy())  # both sides from here on the same feature
    ind = tree["params"]["individual_embeddings"][1]
    if torso:
        xy = rng.uniform(-1, 1, (400, 2)).astype(np.float32)
        pose = rng.randn(1, 6).astype(np.float32) * 0.3
        tind = tree["params"]["torso_individual_codes"][2]
        want = jm.apply(jparams, jnp.asarray(xy), jnp.asarray(pose), jnp.asarray(tind),
                        method=jm.forward_torso)
        with torch.no_grad():
            got = model.forward_torso(torch.from_numpy(xy), torch.from_numpy(pose),
                                      torch.from_numpy(tind))
    else:
        want = jm.apply(jparams, jnp.asarray(xyz), jnp.asarray(d), jfeat, jnp.asarray(ind))
        with torch.no_grad():
            got = model(torch.from_numpy(xyz), torch.from_numpy(d), feat, torch.from_numpy(ind))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_import_radnerf_checkpoint_writes_a_port_checkpoint(tmp_path, torso_sd):
    src = str(tmp_path / "geneface")
    os.makedirs(src)
    torch.save({"state_dict": {"model": {k: torch.from_numpy(v) for k, v in torso_sd.items()}}},
               os.path.join(src, "model_ckpt_steps_250000.ckpt"))
    cfg = dict(CFG, **TORSO)
    path = ti.import_radnerf_checkpoint(src, cfg, str(tmp_path / "port"))
    assert path.endswith("model_ckpt_steps_250000.ckpt")
    ck = load_checkpoint(path)
    assert ck["step"] == 250000 and "opt_state" not in ck["state"]
    state = ck["state"]
    assert_trees_equal(state["params"],
                       ti.radnerf_params_from_torch(torso_sd, port_template(torso=True)))
    H = CFG["grid_size"]
    for g, w in zip(state["occ"], ti.occupancy_from_torch(torso_sd, H, 10.0)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    tg, tmean = state["torso_occ"]
    np.testing.assert_array_equal(tg, torso_sd["density_grid_torso"])
    assert float(tmean) == pytest.approx(float(torso_sd["density_grid_torso"].mean()))
    # the head alone from the same checkpoint
    head = load_checkpoint(ti.import_radnerf_checkpoint(src, cfg, str(tmp_path / "head"),
                                                        torso=False))["state"]
    assert "torso_occ" not in head and "torso_embeddings" not in head["params"]["params"]


# -------------------------------------------------------- BatchNorm models ----
def _perturbed(variables, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + 0.1 * rng.randn(*np.shape(x)).astype(np.float32),
        variables)


def _conv(sd, key, node):
    sd[f"{key}.weight"] = np.asarray(node["kernel"]).transpose(2, 1, 0)
    if "bias" in node:
        sd[f"{key}.bias"] = np.asarray(node["bias"])


def _bn(sd, key, params, stats):
    sd[f"{key}.weight"] = np.asarray(params["scale"])
    sd[f"{key}.bias"] = np.asarray(params["bias"])
    sd[f"{key}.running_mean"] = np.asarray(stats["mean"])
    sd[f"{key}.running_var"] = np.asarray(stats["var"])


def _wn(sd, key, node):
    """A flax ``WN`` → the reference's weight-normed convs (``weight_g`` the
    norm of ``weight_v`` over (in, k), halved, so that the fold scales)."""
    for name, leaf in node.items():
        if name == "cond_layer":
            tk = f"{key}.cond_layer"
        elif name.startswith("in_"):
            tk = f"{key}.in_layers.{name[3:]}"
        else:
            tk = f"{key}.res_skip_layers.{name[len('res_skip_'):]}"
        v = np.asarray(leaf["kernel"]).transpose(2, 1, 0)
        sd[f"{tk}.weight_v"] = v
        sd[f"{tk}.weight_g"] = (0.5 * np.sqrt((v.astype(np.float64) ** 2).sum(
            axis=(1, 2), keepdims=True))).astype(np.float32)
        sd[f"{tk}.bias"] = np.asarray(leaf["bias"])


def vae_reference_sd(v) -> dict:
    """GeneFace ``VAEModel`` keys from a flax ``VAEModel(norm='bn')`` tree."""
    p, s = v["params"], v["batch_stats"]
    sd = {}
    _conv(sd, "mel_encoder.0", p["mel_encoder"]["Conv_0"])
    _bn(sd, "mel_encoder.1", p["mel_encoder"]["BatchNorm_0"], s["mel_encoder"]["BatchNorm_0"])
    _conv(sd, "mel_encoder.3", p["mel_encoder"]["Conv_1"])
    vae = p["vae"]
    _conv(sd, "vae.g_pre_net.0", vae["g_pre_net"])
    for part in ("encoder", "decoder"):
        node = vae[part]
        if part == "encoder":
            _conv(sd, "vae.encoder.pre_net.0", node["pre_0"])
        else:  # ConvTranspose1d weight [in, out, k]
            sd["vae.decoder.pre_net.0.weight"] = np.asarray(
                node["pre_0"]["kernel"]).transpose(1, 2, 0)
            sd["vae.decoder.pre_net.0.bias"] = np.asarray(node["pre_0"]["bias"])
        _wn(sd, f"vae.{part}.wn", node["wn"])
        _conv(sd, f"vae.{part}.out_proj", node["out"])
    for i in range(4):
        cp = vae["prior_flow"][f"couplings_{i}"]
        fk = f"vae.prior_flow.flows.{2 * i}"
        _conv(sd, f"{fk}.pre", cp["pre"])
        _wn(sd, f"{fk}.enc", cp["enc"])
        _conv(sd, f"{fk}.post", cp["Conv_0"])
    return sd


def postnet_reference_sd(v) -> dict:
    """GeneFace ``CNNPostNet`` keys from a flax ``CNNPostNet(norm='bn')`` tree."""
    p, s = v["params"]["_RefinerCore_0"], v["batch_stats"]["_RefinerCore_0"]
    sd = {}
    blocks = ([(f"block1.{i}", i) for i in range(3)] + [(f"block2.{i}", 3 + i) for i in range(3)]
              + [("block3.0", 6)])
    for key, j in blocks:
        _conv(sd, f"{key}.conv_block.0", p[f"_ConvBlock_{j}"]["Conv_0"])
        _bn(sd, f"{key}.conv_block.1", p[f"_ConvBlock_{j}"]["BatchNorm_0"],
            s[f"_ConvBlock_{j}"]["BatchNorm_0"])
    _conv(sd, "block3.1", p["Conv_0"])
    return sd


def test_vae_tree_equals_jax_importer():
    rng = np.random.RandomState(4)
    T2 = 16
    batch = {"hubert": rng.randn(1, T2, 1024).astype(np.float32),
             "y_mask": np.ones((1, T2 // 2), np.float32), "f0": np.zeros((1, T2), np.float32),
             "y": rng.randn(1, T2 // 2, 204).astype(np.float32)}
    jtemplate = JVAE(in_out_dim=204, norm="bn").init(
        jax.random.PRNGKey(0), batch, jax.random.PRNGKey(1), train=True)
    sd = vae_reference_sd(_perturbed(jtemplate, 5))
    want = jax.tree_util.tree_map(np.asarray, jti.vae_model_params_from_torch(sd, jtemplate))
    got = ti.vae_model_params_from_torch(sd, flax_variables(VAEModel(in_out_dim=204, norm="bn")))
    assert_trees_equal(got, want)
    # the fold halved every weight-normed kernel
    v = _perturbed(jtemplate, 5)
    np.testing.assert_allclose(got["params"]["vae"]["encoder"]["wn"]["in_0"]["kernel"],
                               0.5 * v["params"]["vae"]["encoder"]["wn"]["in_0"]["kernel"],
                               rtol=1e-6, atol=1e-7)


def test_postnet_tree_equals_jax_importer():
    jtemplate = JPostNet(204, "bn").init(jax.random.PRNGKey(0), np.zeros((1, 8, 204), np.float32))
    v = _perturbed(jtemplate, 6)
    sd = postnet_reference_sd(v)
    want = jax.tree_util.tree_map(np.asarray, jti.postnet_params_from_torch(sd, jtemplate))
    got = ti.postnet_params_from_torch(sd, flax_variables(CNNPostNet(204, "bn")))
    assert_trees_equal(got, want)
    assert_trees_equal(got, jax.tree_util.tree_map(np.asarray, v))


def test_bn_importers_refuse_a_layernorm_model():
    with pytest.raises(ValueError, match="norm='bn'"):
        ti.postnet_params_from_torch({}, flax_variables(CNNPostNet(204, "ln")))
    with pytest.raises(ValueError, match="norm='bn'"):
        ti.vae_model_params_from_torch({}, flax_variables(VAEModel(in_out_dim=204, norm="ln")))
