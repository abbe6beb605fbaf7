"""Import GeneFace (PyTorch) checkpoints into the port (a copy of
``geneface_tpu/utils/torch_import.py``'s converters, without JAX).

A GeneFace run writes ``checkpoints/<exp>/model_ckpt_steps_*.ckpt``:
``{"state_dict": {"model": <state_dict>, ...}, ...}`` (or, in the older flat
format, dotted ``model.<key>`` names). :func:`load_reference_checkpoint`
reads one into ``{key: numpy array}``; the converters map that onto a
*template*: the flax-layout numpy tree of the port's own module
(:func:`geneface_tpu_torch.convert.state_dict_to_flax` of a RAD-NeRF's
``state_dict``, :func:`geneface_tpu_torch.convert.flax_variables` of a
BatchNorm model), shape-checking every leaf, and return the same tree the
JAX importer builds, with numpy leaves. :func:`import_radnerf_checkpoint`
turns a GeneFace RAD-NeRF checkpoint into a checkpoint of the port
(parameters, occupancy and, for the torso, its 2-D grid), which
``RADNeRFInfer`` renders and ``tasks.run`` fine-tunes.

Layouts (torch → flax): ``Linear.weight [out, in]`` → ``kernel [in, out]``;
``Conv1d.weight [out, in, k]`` → ``[k, in, out]``; ``ConvTranspose1d.weight
[in, out, k]`` → ``[k, in, out]``; weight-normed convs are folded
(``w = g·v/‖v‖``); grid embeddings ``[n_entries, C]`` as they are (the
canonical table of the ``reference`` and ``block`` grid backends; the
``fused`` layout cannot take them).
"""

from __future__ import annotations

import glob
import os
import re
from typing import Mapping

import numpy as np

__all__ = [
    "load_reference_checkpoint",
    "radnerf_params_from_torch",
    "postnet_params_from_torch",
    "syncnet_params_from_torch",
    "fvae_params_from_torch",
    "vae_model_params_from_torch",
    "nerf_backbone_params_from_torch",
    "occupancy_from_torch",
    "torso_density_grid_from_torch",
    "import_radnerf_checkpoint",
    "reference_state_dict",
]


# ------------------------------------------------------------- loading ----
def _newest_checkpoint(path: str) -> str:
    """``path`` itself, or the newest ``model_ckpt_steps_*.ckpt`` of a dir."""
    if not os.path.isdir(path):
        return path
    ckpts = sorted(
        glob.glob(os.path.join(path, "model_ckpt_steps_*.ckpt")),
        key=lambda p: int(re.findall(r"steps_(\d+)", p)[0]),
    )
    if not ckpts:
        raise FileNotFoundError(f"no model_ckpt_steps_*.ckpt under {path}")
    return ckpts[-1]


def load_reference_checkpoint(path: str, model_name: str = "model") -> dict:
    """A GeneFace trainer checkpoint (a ``.ckpt`` file, or a work dir: its
    newest ``model_ckpt_steps_*.ckpt``) → ``{key: numpy array}`` of the
    sub-module ``model_name`` (``{"state_dict": {model_name: ...}}``, or the
    dotted ``model_name.<key>`` names of the flat format). Read with
    ``weights_only=True``: tensors and containers only."""
    import torch

    payload = torch.load(_newest_checkpoint(path), map_location="cpu", weights_only=True)
    state = payload.get("state_dict", payload)
    if model_name in state and isinstance(state[model_name], dict):
        state = state[model_name]
    elif any("." in k for k in state):
        prefix = model_name + "."
        sub = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
        state = sub or state
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


# ------------------------------------------------------------- helpers ----
def _lin(sd: Mapping, key: str) -> np.ndarray:
    """torch Linear weight → flax Dense kernel."""
    return np.asarray(sd[key]).T


def _conv1d(sd: Mapping, key: str) -> np.ndarray:
    """torch Conv1d weight [out, in, k] → flax kernel [k, in, out]."""
    return np.asarray(sd[key]).transpose(2, 1, 0)


def _arr(sd: Mapping, key: str) -> np.ndarray:
    return np.asarray(sd[key])


def _assign(tree: dict, path: tuple, value: np.ndarray, torch_key: str, hint: str = ""):
    """Shape-checked write of ``value`` at ``tree[path...]``, in the
    template leaf's dtype."""
    node = tree
    missing = KeyError(f"target params have no '{'/'.join(path)}' "
                       f"(for torch key '{torch_key}'). {hint}")
    for p in path[:-1]:
        if p not in node:
            raise missing
        node = node[p]
    leaf = node.get(path[-1])
    if leaf is None:
        raise missing
    if tuple(np.shape(leaf)) != tuple(value.shape):
        raise ValueError(
            f"shape mismatch at {'/'.join(path)} (torch '{torch_key}'): "
            f"checkpoint {tuple(value.shape)} vs model {tuple(np.shape(leaf))}. {hint}"
        )
    node[path[-1]] = value.astype(np.asarray(leaf).dtype)


def _to_mutable(tree):
    """A copy of the containers of ``tree`` (the leaves are shared)."""
    if isinstance(tree, Mapping):
        return {k: _to_mutable(v) for k, v in tree.items()}
    return tree


def _finalize(tree):
    """Every leaf a numpy array."""
    if isinstance(tree, dict):
        return {k: _finalize(v) for k, v in tree.items()}
    return np.asarray(tree)


_GRID_HINT = (
    "Reference checkpoints use the CUDA gridencoder geometry — set "
    "grid_num_levels: 16, grid_level_dim: 2 (and matching log2_hashmap_size/"
    "desired_resolution) in the config, and grid_backend: 'reference' for "
    "bit-exact hash-level semantics."
)


def _import_audionet(sd, out, prefix_t, prefix_f):
    for i, t_idx in enumerate((0, 2, 4, 6)):
        key = f"{prefix_t}.encoder_conv.{t_idx}"
        _assign(out, (prefix_f, f"Conv1dK3_{i}", "kernel"), _conv1d(sd, f"{key}.weight"),
                f"{key}.weight")
        _assign(out, (prefix_f, f"Conv1dK3_{i}", "bias"), _arr(sd, f"{key}.bias"),
                f"{key}.bias")
    for i, t_idx in enumerate((0, 2)):
        key = f"{prefix_t}.encoder_fc1.{t_idx}"
        _assign(out, (prefix_f, f"Dense_{i}", "kernel"), _lin(sd, f"{key}.weight"),
                f"{key}.weight")
        _assign(out, (prefix_f, f"Dense_{i}", "bias"), _arr(sd, f"{key}.bias"), f"{key}.bias")


def _import_attnet(sd, out, prefix_t, prefix_f):
    for i, t_idx in enumerate((0, 2, 4, 6, 8)):
        key = f"{prefix_t}.attentionConvNet.{t_idx}"
        _assign(out, (prefix_f, f"Conv1dK3_{i}", "kernel"), _conv1d(sd, f"{key}.weight"),
                f"{key}.weight")
        _assign(out, (prefix_f, f"Conv1dK3_{i}", "bias"), _arr(sd, f"{key}.bias"),
                f"{key}.bias")
    key = f"{prefix_t}.attentionNet.0"
    _assign(out, (prefix_f, "Dense_0", "kernel"), _lin(sd, f"{key}.weight"), f"{key}.weight")
    _assign(out, (prefix_f, "Dense_0", "bias"), _arr(sd, f"{key}.bias"), f"{key}.bias")


def _import_mlp(sd, out, prefix_t, prefix_f, n_layers):
    for i in range(n_layers):
        _assign(out, (prefix_f, f"Dense_{i}", "kernel"), _lin(sd, f"{prefix_t}.net.{i}.weight"),
                f"{prefix_t}.net.{i}.weight")


# ------------------------------------------------------------- RADNeRF ----
def radnerf_params_from_torch(sd: Mapping, params: Mapping) -> dict:
    """GeneFace ``RADNeRF`` / ``RADNeRFTorso`` state_dict → the flax-layout
    numpy tree ``{"params": ...}``, on the template ``params`` (the port's
    ``state_dict_to_flax(model.state_dict())``; shapes checked leaf by
    leaf). The torso's extras come in when both the template and the
    state_dict carry them. A template of the ``fused`` layout raises."""
    _p = params["params"] if "params" in params else params
    if isinstance(_p.get("pos_embeddings"), Mapping):
        raise ValueError(
            "cannot import torch grid embeddings into the fused grid layout "
            "— set grid_backend: 'reference' (or 'block') in the config for "
            "checkpoint import (docs/migrate_from_geneface.md)"
        )
    tree = _to_mutable(params)
    out = tree["params"]

    _assign(out, ("pos_embeddings",), _arr(sd, "position_embedder.embeddings"),
            "position_embedder.embeddings", _GRID_HINT)
    _assign(out, ("ambient_embeddings",), _arr(sd, "ambient_embedder.embeddings"),
            "ambient_embedder.embeddings", _GRID_HINT)
    if "individual_embeddings" in sd and "individual_embeddings" in out:
        _assign(out, ("individual_embeddings",), _arr(sd, "individual_embeddings"),
                "individual_embeddings")

    _import_audionet(sd, out, "cond_prenet", "cond_prenet")
    if "cond_att_net.attentionNet.0.weight" in sd and "cond_att_net" in out:
        _import_attnet(sd, out, "cond_att_net", "cond_att_net")

    def n_dense(name):
        return sum(1 for k in out[name] if k.startswith("Dense_"))

    for name in ("ambient_net", "sigma_net", "color_net"):
        _import_mlp(sd, out, name, name, n_dense(name))

    # ---- the torso's extras (a RADNeRFTorso checkpoint) ----
    if "torso_embedder.embeddings" in sd and "torso_embeddings" in out:
        _assign(out, ("torso_embeddings",), _arr(sd, "torso_embedder.embeddings"),
                "torso_embedder.embeddings", _GRID_HINT)
        if "torso_individual_codes" in sd and "torso_individual_codes" in out:
            _assign(out, ("torso_individual_codes",), _arr(sd, "torso_individual_codes"),
                    "torso_individual_codes")
        _import_mlp(sd, out, "torso_deform_net", "torso_deform_net",
                    n_dense("torso_deform_net"))
        # the reference spells it "canonicial"
        _import_mlp(sd, out, "torso_canonicial_net", "torso_canonical_net",
                    n_dense("torso_canonical_net"))
        # as in the JAX importer: the head-aware encoder's target is a
        # top-level "Dense_0", which neither package's torso holds (its
        # layers are "head_aware_mlps_<i>"), so it is left at the template
        if "head_color_weights_encoder.0.weight" in sd and "Dense_0" in out:
            for i, t_idx in enumerate((0, 2, 4)):
                key = f"head_color_weights_encoder.{t_idx}"
                _assign(out, (f"Dense_{i}", "kernel"), _lin(sd, f"{key}.weight"),
                        f"{key}.weight")
                _assign(out, (f"Dense_{i}", "bias"), _arr(sd, f"{key}.bias"), f"{key}.bias")
    return _finalize(tree)


# ----------------------------------------------------------- occupancy ----
def occupancy_from_torch(sd: Mapping, grid_size: int, density_thresh: float):
    """The reference's ``density_grid [CAS·H³]`` buffer → the port's
    ``OccupancyState`` (numpy leaves): the first cascade's densities, the
    boolean grid ``density > min(mean density, thresh)`` (the mean over the
    trained cells, ``>= 0``) and that mean."""
    from geneface_tpu_torch.models.radnerf.renderer import OccupancyState

    dg = np.asarray(sd["density_grid"], np.float32).reshape(1, -1)[:, : grid_size**3]
    valid = dg >= 0  # -1 marks untrained cells
    mean_density = float(dg[valid].mean()) if valid.any() else 0.0
    thresh = min(mean_density, density_thresh)
    occ = (dg > thresh).reshape(1, grid_size, grid_size, grid_size)
    return OccupancyState(density_grid=dg, occ_grid=occ,
                          mean_density=np.asarray(mean_density, np.float32))


def torso_density_grid_from_torch(sd: Mapping, grid_size: int) -> np.ndarray:
    """The torso's ``density_grid_torso [H·H]`` buffer → ``[H, H]``."""
    return np.asarray(sd["density_grid_torso"], np.float32).reshape(grid_size, grid_size)


def import_radnerf_checkpoint(path: str, cfg, out_dir: str, torso: bool | None = None) -> str:
    """A GeneFace RAD-NeRF checkpoint (file or work dir) → a checkpoint of
    the port, ``out_dir/model_ckpt_steps_<N>.ckpt`` (``N`` from the source's
    name), → its path.

    The model is the config's (``grid_backend`` ``reference`` or ``block``,
    16 × 2 levels: ``lm3d_radnerf_import.yaml``); ``torso`` ``None`` imports
    a torso checkpoint as a torso (its head only with ``False``). The state
    holds the parameters, the occupancy of :func:`occupancy_from_torch` and,
    for a torso, ``torso_occ`` = (the 2-D grid, its mean), and no optimizer
    state: a fine-tune starts a fresh optimizer at step ``N``."""
    import torch

    from geneface_tpu_torch.convert import state_dict_to_flax
    from geneface_tpu_torch.models.radnerf import model_from_cfg
    from geneface_tpu_torch.utils.checkpoint import save_checkpoint

    src = _newest_checkpoint(path)
    sd = load_reference_checkpoint(src)
    if torso is None:
        torso = "torso_embedder.embeddings" in sd
    with torch.device("meta"):  # shapes only: the template's leaves are zeros
        model = model_from_cfg(cfg, torso=torso)
    template = state_dict_to_flax(
        {k: np.zeros(v.shape, np.float32) for k, v in model.state_dict().items()})
    params = radnerf_params_from_torch(sd, template)
    grid_size = int(cfg.get("grid_size", 128))
    state = {"params": params,
             "occ": tuple(occupancy_from_torch(sd, grid_size,
                                               float(cfg.get("density_thresh", 10))))}
    if torso:
        tg = torso_density_grid_from_torch(sd, grid_size).reshape(-1)
        state["torso_occ"] = (tg, np.asarray(tg.mean(), np.float32))
    found = re.findall(r"steps_(\d+)", os.path.basename(src))
    step = int(found[0]) if found else 0
    dst = os.path.join(out_dir, f"model_ckpt_steps_{step}.ckpt")
    save_checkpoint(dst, {"state": state, "step": step})
    return dst


def reference_state_dict(model) -> dict:
    """The GeneFace ``state_dict`` (numpy, its key names and layouts) of a
    port ``RADNeRF`` / ``RADNeRFTorso`` with canonical grids: the inverse of
    :func:`radnerf_params_from_torch` (the head-aware encoder excepted). The
    density-grid buffers are not part of a model; add them to the dict."""
    names = {"pos_embeddings": "position_embedder.embeddings",
             "ambient_embeddings": "ambient_embedder.embeddings",
             "torso_embeddings": "torso_embedder.embeddings",
             "cond_prenet.fc1": "cond_prenet.encoder_fc1.0",
             "cond_prenet.fc2": "cond_prenet.encoder_fc1.2",
             "cond_att_net.fc": "cond_att_net.attentionNet.0"}
    out = {}
    for name, t in model.state_dict().items():
        v = t.detach().cpu().numpy()
        if name.startswith("head_aware_mlps"):
            raise ValueError("the head-aware encoder has no GeneFace key in the importer")
        m = re.fullmatch(r"(cond_prenet|cond_att_net)\.convs\.(\d+)\.(weight|bias)", name)
        if m:
            conv = "encoder_conv" if m.group(1) == "cond_prenet" else "attentionConvNet"
            key = f"{m.group(1)}.{conv}.{2 * int(m.group(2))}.{m.group(3)}"
        else:
            m = re.fullmatch(r"(\w+_net)\.layers\.(\d+)\.weight", name)
            if m:
                net = "torso_canonicial_net" if m.group(1) == "torso_canonical_net" else m.group(1)
                key = f"{net}.net.{m.group(2)}.weight"
            else:
                stem, _, leaf = name.rpartition(".")
                key = names.get(name) or (f"{names[stem]}.{leaf}" if stem in names else name)
        out[key] = np.array(v, np.float32)
    return out


# ---------------------------------------------------- BN-block families ----
def _import_convbn(sd, params, stats, t_key, f_block, conv_name="Conv_0",
                   bn_name="BatchNorm_0"):
    """One reference conv block (``Conv1d`` + ``BatchNorm1d``) → a
    ``ConvBlock`` built with ``norm='bn'`` (params and batch_stats)."""
    _assign(params, (f_block, conv_name, "kernel"), _conv1d(sd, f"{t_key}.conv_block.0.weight"),
            f"{t_key}.conv_block.0.weight")
    _assign(params, (f_block, conv_name, "bias"), _arr(sd, f"{t_key}.conv_block.0.bias"),
            f"{t_key}.conv_block.0.bias")
    _assign(params, (f_block, bn_name, "scale"), _arr(sd, f"{t_key}.conv_block.1.weight"),
            f"{t_key}.conv_block.1.weight")
    _assign(params, (f_block, bn_name, "bias"), _arr(sd, f"{t_key}.conv_block.1.bias"),
            f"{t_key}.conv_block.1.bias")
    _assign(stats, (f_block, bn_name, "mean"), _arr(sd, f"{t_key}.conv_block.1.running_mean"),
            f"{t_key}.conv_block.1.running_mean")
    _assign(stats, (f_block, bn_name, "var"), _arr(sd, f"{t_key}.conv_block.1.running_var"),
            f"{t_key}.conv_block.1.running_var")


_BN_HINT = "Build the model with norm='bn' to import reference checkpoints."


def postnet_params_from_torch(sd: Mapping, variables: Mapping) -> dict:
    """GeneFace ``CNNPostNet`` / ``PitchContourCNNPostNet`` → the
    flax-layout variables on the template ``variables`` (the port's
    ``flax_variables`` of a post-net built with ``norm='bn'``)."""
    tree = _to_mutable(variables)
    if "batch_stats" not in tree:
        raise ValueError(f"variables have no batch_stats. {_BN_HINT}")
    core = "_RefinerCore_0"
    params = tree["params"][core]
    stats = tree["batch_stats"][core]
    blocks = (
        [(f"block1.{i}", f"_ConvBlock_{i}") for i in range(3)]
        + [(f"block2.{i}", f"_ConvBlock_{3 + i}") for i in range(3)]
        + [("block3.0", "_ConvBlock_6")]
    )
    for t_key, f_block in blocks:
        _import_convbn(sd, {f_block: params[f_block]}, {f_block: stats[f_block]}, t_key, f_block)
    _assign(params, ("Conv_0", "kernel"), _conv1d(sd, "block3.1.weight"), "block3.1.weight")
    _assign(params, ("Conv_0", "bias"), _arr(sd, "block3.1.bias"), "block3.1.bias")
    return _finalize(tree)


def syncnet_params_from_torch(sd: Mapping, variables: Mapping) -> dict:
    """GeneFace ``LandmarkHubertSyncNet`` → the flax-layout variables on the
    template ``variables`` (the port's ``flax_variables`` of a SyncNet built
    with ``norm='bn'``): ``hubert_encoder.<i>`` → ``ConvBlock_<i>``,
    ``mouth_encoder.<i>`` → ``ConvBlock_<13 + i>`` (the audio tower is
    traced first in flax)."""
    tree = _to_mutable(variables)
    if "batch_stats" not in tree:
        raise ValueError(f"variables have no batch_stats. {_BN_HINT}")
    params, stats = tree["params"], tree["batch_stats"]
    for i in range(13):
        _import_convbn(sd, params, stats, f"hubert_encoder.{i}", f"ConvBlock_{i}")
        _import_convbn(sd, params, stats, f"mouth_encoder.{i}", f"ConvBlock_{13 + i}")
    return _finalize(tree)


# ------------------------------------------------------------ FVAE / VAE ----
def _wn_conv(sd: Mapping, key: str) -> np.ndarray:
    """A weight-normed torch Conv1d folded into a plain flax kernel:
    per output channel ``w = g·v/‖v‖`` over (in, k) in float64, then
    ``[out, in, k]`` → ``[k, in, out]``."""
    gkey = f"{key}.weight_g"
    if gkey not in sd and f"{key}.weight" in sd:  # not weight-normed after all
        return _conv1d(sd, f"{key}.weight")
    v = np.asarray(sd[f"{key}.weight_v"], np.float64)
    g = np.asarray(sd[gkey], np.float64)
    norm = np.sqrt((v**2).sum(axis=(1, 2), keepdims=True))
    w = (g * v / np.maximum(norm, 1e-12)).astype(np.float32)
    return w.transpose(2, 1, 0)


def _convT1d(sd: Mapping, key: str) -> np.ndarray:
    """torch ConvTranspose1d weight [in, out, k] → flax [k, in, out]."""
    return np.asarray(sd[key]).transpose(2, 0, 1)


def _import_wn(sd, out, prefix_t, n_layers, has_cond=True):
    """A reference ``WN`` stack → the ``WN`` submodule dict."""
    if has_cond and f"{prefix_t}.cond_layer.weight_v" in sd:
        _assign(out, ("cond_layer", "kernel"), _wn_conv(sd, f"{prefix_t}.cond_layer"),
                f"{prefix_t}.cond_layer.weight_v")
        _assign(out, ("cond_layer", "bias"), _arr(sd, f"{prefix_t}.cond_layer.bias"),
                f"{prefix_t}.cond_layer.bias")
    for i in range(n_layers):
        for t_name, f_name in (("in_layers", "in"), ("res_skip_layers", "res_skip")):
            key = f"{prefix_t}.{t_name}.{i}"
            _assign(out, (f"{f_name}_{i}", "kernel"), _wn_conv(sd, key), f"{key}.weight_v")
            _assign(out, (f"{f_name}_{i}", "bias"), _arr(sd, f"{key}.bias"), f"{key}.bias")


def _wn_layers(sd, prefix_t):
    return len({k.split(".")[-2] for k in sd if k.startswith(f"{prefix_t}.in_layers.")})


def fvae_params_from_torch(sd: Mapping, params: dict, prefix_t: str = "") -> dict:
    """GeneFace ``FVAE`` → the FVAE params dict (``params`` is the
    ``"params"`` subtree of the template; written in place and returned).
    ``prefix_t``: e.g. ``"vae."`` inside a ``VAEModel``."""
    out = params

    def t(key):
        return f"{prefix_t}{key}"

    _assign(out, ("g_pre_net", "kernel"), _conv1d(sd, t("g_pre_net.0.weight")),
            t("g_pre_net.0.weight"))
    _assign(out, ("g_pre_net", "bias"), _arr(sd, t("g_pre_net.0.bias")), t("g_pre_net.0.bias"))

    enc = out["encoder"]
    _assign(enc, ("pre_0", "kernel"), _conv1d(sd, t("encoder.pre_net.0.weight")),
            t("encoder.pre_net.0.weight"))
    _assign(enc, ("pre_0", "bias"), _arr(sd, t("encoder.pre_net.0.bias")),
            t("encoder.pre_net.0.bias"))
    _import_wn(sd, enc["wn"], t("encoder.wn"), _wn_layers(sd, t("encoder.wn")))
    _assign(enc, ("out", "kernel"), _conv1d(sd, t("encoder.out_proj.weight")),
            t("encoder.out_proj.weight"))
    _assign(enc, ("out", "bias"), _arr(sd, t("encoder.out_proj.bias")),
            t("encoder.out_proj.bias"))

    dec = out["decoder"]
    _assign(dec, ("pre_0", "kernel"), _convT1d(sd, t("decoder.pre_net.0.weight")),
            t("decoder.pre_net.0.weight"))
    _assign(dec, ("pre_0", "bias"), _arr(sd, t("decoder.pre_net.0.bias")),
            t("decoder.pre_net.0.bias"))
    _import_wn(sd, dec["wn"], t("decoder.wn"), _wn_layers(sd, t("decoder.wn")))
    _assign(dec, ("out", "kernel"), _conv1d(sd, t("decoder.out_proj.weight")),
            t("decoder.out_proj.weight"))
    _assign(dec, ("out", "bias"), _arr(sd, t("decoder.out_proj.bias")),
            t("decoder.out_proj.bias"))

    # the prior flow: torch flows.{2i} are the couplings (the odd ones flips)
    if "prior_flow" in out:
        pf = out["prior_flow"]
        n_flows = sum(1 for k in pf if k.startswith("couplings_"))
        for i in range(n_flows):
            cp = pf[f"couplings_{i}"]
            fk = t(f"prior_flow.flows.{2 * i}")
            _assign(cp, ("pre", "kernel"), _conv1d(sd, f"{fk}.pre.weight"), f"{fk}.pre.weight")
            _assign(cp, ("pre", "bias"), _arr(sd, f"{fk}.pre.bias"), f"{fk}.pre.bias")
            _import_wn(sd, cp["enc"], f"{fk}.enc", _wn_layers(sd, f"{fk}.enc"))
            _assign(cp, ("Conv_0", "kernel"), _conv1d(sd, f"{fk}.post.weight"),
                    f"{fk}.post.weight")
            _assign(cp, ("Conv_0", "bias"), _arr(sd, f"{fk}.post.bias"), f"{fk}.post.bias")

    for name in ("query_proj", "key_proj", "value_proj"):
        if name in out and t(f"{name}.weight") in sd:
            _assign(out, (name, "kernel"), _lin(sd, t(f"{name}.weight")), t(f"{name}.weight"))
            _assign(out, (name, "bias"), _arr(sd, t(f"{name}.bias")), t(f"{name}.bias"))
    return out


def _import_cond_conv_encoder(sd, params, stats, prefix_t, prefix_f):
    """A reference mel/pitch encoder (bias-free conv, BatchNorm, GELU,
    bias-free conv) → ``_CondConvEncoder`` with ``norm='bn'``."""
    _assign(params, (prefix_f, "Conv_0", "kernel"), _conv1d(sd, f"{prefix_t}.0.weight"),
            f"{prefix_t}.0.weight")
    _assign(params, (prefix_f, "BatchNorm_0", "scale"), _arr(sd, f"{prefix_t}.1.weight"),
            f"{prefix_t}.1.weight")
    _assign(params, (prefix_f, "BatchNorm_0", "bias"), _arr(sd, f"{prefix_t}.1.bias"),
            f"{prefix_t}.1.bias")
    _assign(stats, (prefix_f, "BatchNorm_0", "mean"), _arr(sd, f"{prefix_t}.1.running_mean"),
            f"{prefix_t}.1.running_mean")
    _assign(stats, (prefix_f, "BatchNorm_0", "var"), _arr(sd, f"{prefix_t}.1.running_var"),
            f"{prefix_t}.1.running_var")
    _assign(params, (prefix_f, "Conv_1", "kernel"), _conv1d(sd, f"{prefix_t}.3.weight"),
            f"{prefix_t}.3.weight")


def vae_model_params_from_torch(sd: Mapping, variables: Mapping) -> dict:
    """GeneFace ``VAEModel`` / ``PitchContourVAEModel`` → the flax-layout
    variables on the template ``variables`` (the port's ``flax_variables``
    of a ``VAEModel`` built with ``norm='bn'``)."""
    tree = _to_mutable(variables)
    if "batch_stats" not in tree:
        raise ValueError(f"variables have no batch_stats. {_BN_HINT}")
    params, stats = tree["params"], tree["batch_stats"]
    _import_cond_conv_encoder(sd, params, stats, "mel_encoder", "mel_encoder")
    if "pitch_encoder" in params and "pitch_encoder.0.weight" in sd:
        _import_cond_conv_encoder(sd, params, stats, "pitch_encoder", "pitch_encoder")
        _assign(params, ("pitch_embed", "embedding"), _arr(sd, "pitch_embed.weight"),
                "pitch_embed.weight")
    fvae_params_from_torch(sd, params["vae"], prefix_t="vae.")
    return _finalize(tree)


# --------------------------------------------------------- vanilla NeRF ----
def nerf_backbone_params_from_torch(sd: Mapping, params, prefix_t: str = "") -> dict:
    """GeneFace ``NeRFBackbone`` (``modules/nerfs/adnerf/backbone.py:82-135``)
    state_dict → the flax-layout tree ``{"params": {"Dense_<i>": ...}}`` on
    the template ``params``: one backbone's subtree of
    :func:`~geneface_tpu_torch.convert.nerf_state_dict_to_flax`, e.g.
    ``{"params": nerf_state_dict_to_flax(model.state_dict())["params"]
    ["model_coarse"]}``.

    Dense numbering: 0..D-1 density_linears, D density_out, D+1..D+C
    color_linears, D+C+1 color_out. ``prefix_t`` selects a sub-module of a
    larger state_dict (e.g. ``"model_coarse."``).
    """
    tree = _to_mutable(params)
    out = tree["params"]
    dd = [k for k in sd if k.startswith(f"{prefix_t}density_linears.")]
    n_density = len({k.split(".")[-2] for k in dd})
    cc = [k for k in sd if k.startswith(f"{prefix_t}color_linears.")]
    n_color = len({k.split(".")[-2] for k in cc})

    def put(i, t_key):
        _assign(out, (f"Dense_{i}", "kernel"), _lin(sd, f"{t_key}.weight"),
                f"{t_key}.weight")
        _assign(out, (f"Dense_{i}", "bias"), _arr(sd, f"{t_key}.bias"),
                f"{t_key}.bias")

    for i in range(n_density):
        put(i, f"{prefix_t}density_linears.{i}")
    put(n_density, f"{prefix_t}density_out_linear")
    for i in range(n_color):
        put(n_density + 1 + i, f"{prefix_t}color_linears.{i}")
    put(n_density + 1 + n_color, f"{prefix_t}color_out_linear")
    return _finalize(tree)
