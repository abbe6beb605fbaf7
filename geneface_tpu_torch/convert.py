"""Flax parameter tree (numpy leaves) ↔ the port's ``state_dict``.

The JAX checkpoints hold ``{"params": {...}}`` trees of the flax RAD-NeRF.
The mapping, module by module:

- grid tables ``{pos,ambient,torso}_embeddings/group_<i>`` (the fused
  layout) and ``{pos,ambient,torso}_embeddings`` (the canonical
  ``[n_entries, C]`` table of the reference and block layouts) are kept as
  they are;
- ``Conv1dK3_<j>``: kernel ``[3, Cin, Cout]`` → ``convs.<j>.weight``
  ``[Cout, Cin, 3]`` (``Conv1d`` layout), bias as it is;
- ``AudioNet`` ``Dense_0/1`` → ``fc1``/``fc2``, ``AudioAttNet`` ``Dense_0``
  → ``fc`` (kernel ``[in, out]`` → ``weight [out, in]``, with bias);
- the bias-free MLP layers ``Dense_<i>/kernel`` (``_SplitDense`` and the
  ``_KernelHolder`` of split heads alike, the torso's deform and canonical
  nets too) → ``layers.<i>.weight``;
- the torso's biased ``head_aware_mlps_<i>/{kernel,bias}`` →
  ``head_aware_mlps.<i>.{weight,bias}``;
- ``individual_embeddings`` and ``torso_individual_codes`` as they are.

The audio-side models (HuBERT, the Audio2Motion VAE, the post-net) name
their submodules as flax does, so :func:`load_flax_variables` and
:func:`flax_variables` map them by name and module type:

- ``Conv1d``: kernel ``[K, Cin/groups, Cout]`` ↔ weight ``[Cout, Cin/groups, K]``;
- ``ConvTranspose1d``: flax's ``ConvTranspose`` (``transpose_kernel=False``)
  applies its kernel unflipped to the dilated input, torch's the flipped
  one, so kernel ``[K, Cin, Cout]`` ↔ weight ``[Cin, Cout, K]`` reversed
  along ``K`` (the ``SAME`` padding at kernel = stride then aligns both);
- ``Linear``: kernel ``[in, out]`` ↔ weight ``[out, in]``;
- ``LayerNorm``/``GroupNorm``: ``scale`` ↔ ``weight``; ``BatchNorm1d`` also
  ``batch_stats`` ``mean``/``var`` ↔ ``running_mean``/``running_var``;
- ``Embedding``: ``embedding`` ↔ ``weight``;
- ``PReLU``: flax's scalar ``negative_slope`` ↔ ``weight [1]``;
- the attention's ``DenseGeneral`` projections (``Linear`` layers with
  ``flax_shapes``): ``query``/``key``/``value`` kernels ``[in, heads,
  head_dim]`` and biases ``[heads, head_dim]``, the ``out`` kernel
  ``[heads, head_dim, out]`` ↔ the ``Linear``'s weight ``[out, in]`` and
  bias;
- parameters a module holds itself under their flax names
  (``flax_leaves``): ``ActNorm``'s ``logs``/``bias`` ``(1, 1, C)`` ↔
  ``[1, C, 1]``, ``InvConvNear.weight`` ``[S, S]``, the quantizer's
  ``codebook`` and ``FFTBlocks``' ``pos_alpha`` as they are;
- ``Conv2d`` (the datagen networks: BiSeNet, FAN, ReconNet): kernel
  ``HWIO`` ↔ weight ``OIHW``; ``BatchNorm2d`` as ``BatchNorm1d``.
  :func:`load_flax_npz` reads the flattened ``.npz`` (``params/…``,
  ``batch_stats/…`` keys) that the JAX package's weight converters write.

The audio2pose WaveNet-GMM (``audio_fc1``/``audio_fc2``, ``backbone/
start1``, ``start2``, ``block_<i>/{filter,gate,cond_filter,cond_gate,res,
skip}``, ``end1``, ``end2``) goes the same way: flax ``Dense`` ↔ ``Linear``,
and its causal ``Conv`` kernels ``[K, Cin, Cout]`` ↔ ``Conv1d`` weights
``[Cout, Cin, K]`` (no flip: the port pads on the left as flax's ``VALID``
conv of the left-padded input reads it).

SyncNet (``ConvBlock_0..25``, each ``Conv_0`` and ``LayerNorm_0`` or
``BatchNorm_0``) and the post-net's ``MLPDiscriminator`` (``Dense_0..3``
with bias, ``Dense_4`` without) are mapped the same way, by their flax
names. :func:`flax_param_tree` and :func:`param_values_from_flax` map any
per-parameter tensors of such a model (the optimizers' moments) to and from
the same layout.

The vanilla NeRF family (:mod:`geneface_tpu_torch.models.nerf`):
:func:`nerf_flax_to_state_dict` and :func:`nerf_state_dict_to_flax` map the
flax tree both ways, :func:`nerf_flax_path` names one entry's flax path:

- ``model_{coarse,fine}/Dense_<i>`` (``Dense_8`` is sigma, ``Dense_12``
  rgb) ↔ ``model_{coarse,fine}.layers.<i>``;
- the window reducers ``lm_encoder``/``aud_net``: ``Conv1dK3_<j>`` ↔
  ``convs.<j>`` (kernel ``[3, Cin, Cout]`` ↔ weight ``[Cout, Cin, 3]``),
  ``Dense_0/1`` ↔ ``fc1``/``fc2``; the attention nets
  ``lmatt_encoder``/``audatt_net``: ``Conv1dK3_<j>`` and ``Dense_0`` ↔
  ``fc``;
- the MLP lists ``lm_encoder_mlp_<i>`` and ``color_encoder_<i>`` ↔
  ``lm_encoder_mlp.<i>`` and ``color_encoder.<i>``;

every ``Dense`` with its bias, kernel ``[in, out]`` ↔ weight ``[out, in]``.

DeepSpeech (:mod:`geneface_tpu_torch.datagen.deepspeech`):
:func:`deepspeech_state_dict` and :func:`deepspeech_params` map the frozen
graph's param dict ``{h1, b1, h2, b2, h3, b3, lstm_kernel, lstm_bias, h5,
b5, h6, b6}`` (TF dense kernels ``[in, out]``) ↔ ``h<i>.weight [out, in]``,
``h<i>.bias``, and the LSTM's ``lstm_kernel``/``lstm_bias`` as they are.

LPIPS (:mod:`geneface_tpu_torch.models.lpips`): :func:`lpips_state_dict` and
:func:`lpips_flax_params` map the flax tree ``alex/conv{i}/{kernel,bias}``
(kernel HWIO) and ``lin{i}`` ↔ ``alex.conv{i}.{weight,bias}`` (weight
OIHW) and ``lin{i}``.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

__all__ = [
    "flax_path",
    "flax_to_state_dict",
    "state_dict_to_flax",
    "load_flax_variables",
    "flax_variables",
    "flax_param_tree",
    "param_values_from_flax",
    "lpips_state_dict",
    "lpips_flax_params",
    "load_flax_npz",
    "nerf_flax_path",
    "nerf_flax_to_state_dict",
    "nerf_state_dict_to_flax",
    "deepspeech_state_dict",
    "deepspeech_params",
]

_AUDIO_DENSE = {
    ("cond_prenet", "Dense_0"): "fc1",
    ("cond_prenet", "Dense_1"): "fc2",
    ("cond_att_net", "Dense_0"): "fc",
}
_AUDIO_DENSE_INV = {v: k[1] for k, v in _AUDIO_DENSE.items()}
_GRIDS = ("pos_embeddings", "ambient_embeddings", "torso_embeddings")
_CODES = ("individual_embeddings", "torso_individual_codes")
_MLPS = ("ambient_net", "sigma_net", "color_net", "torso_deform_net", "torso_canonical_net")


def _flatten(tree: dict, prefix: tuple = ()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def flax_to_state_dict(params: dict) -> dict:
    """``params``: the flax tree (with or without the outer ``"params"``
    level) → ``{name: numpy array}`` for ``RADNeRF.load_state_dict``."""
    tree = params.get("params", params)
    sd = {}
    for path, v in _flatten(tree).items():
        top = path[0]
        if top in _GRIDS:
            sd[".".join(path)] = v
        elif top in _CODES:
            sd[top] = v
        elif re.fullmatch(r"head_aware_mlps_\d+", top):
            i = top.rsplit("_", 1)[1]
            sd[f"head_aware_mlps.{i}.{'weight' if path[1] == 'kernel' else 'bias'}"] = (
                v.T if path[1] == "kernel" else v
            )
        elif top in ("cond_prenet", "cond_att_net"):
            layer, leaf = path[1], path[2]
            m = re.fullmatch(r"Conv1dK3_(\d+)", layer)
            if m:
                name = f"{top}.convs.{m.group(1)}"
                sd[f"{name}.{'weight' if leaf == 'kernel' else 'bias'}"] = (
                    v.transpose(2, 1, 0) if leaf == "kernel" else v
                )
            else:
                name = f"{top}.{_AUDIO_DENSE[(top, layer)]}"
                sd[f"{name}.{'weight' if leaf == 'kernel' else 'bias'}"] = (
                    v.T if leaf == "kernel" else v
                )
        elif top in _MLPS:
            i = re.fullmatch(r"Dense_(\d+)", path[1]).group(1)
            sd[f"{top}.layers.{i}.weight"] = v.T
        else:
            raise KeyError(f"unexpected parameter {'/'.join(path)}")
    return {k: np.array(v, order="C") for k, v in sd.items()}


def flax_path(name: str) -> tuple:
    """The flax parameter path of a ``state_dict`` entry (without the outer
    ``"params"`` level): e.g. ``"cond_att_net.fc.weight"`` →
    ``("cond_att_net", "Dense_0", "kernel")``."""
    parts = name.split(".")
    top = parts[0]
    if top in _GRIDS:
        return tuple(parts)
    if top in _CODES:
        return (top,)
    if top == "head_aware_mlps":
        return (f"head_aware_mlps_{parts[1]}", "kernel" if parts[2] == "weight" else "bias")
    if top in ("cond_prenet", "cond_att_net") and parts[1] == "convs":
        return (top, f"Conv1dK3_{parts[2]}", "kernel" if parts[3] == "weight" else "bias")
    if top in ("cond_prenet", "cond_att_net"):
        return (top, _AUDIO_DENSE_INV[parts[1]], "kernel" if parts[2] == "weight" else "bias")
    if top in _MLPS:
        return (top, f"Dense_{parts[2]}", "kernel")
    raise KeyError(f"unexpected state_dict entry {name}")


def state_dict_to_flax(state_dict: dict) -> dict:
    """Inverse of :func:`flax_to_state_dict` → ``{"params": tree}``."""
    tree: dict = {}
    for name, t in state_dict.items():
        v = t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)
        path = flax_path(name)
        if path[-1] == "kernel":
            # Conv1d [Cout, Cin, 3] -> [3, Cin, Cout]; Linear [out, in] -> [in, out]
            v = v.transpose(2, 1, 0) if v.ndim == 3 else v.T
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(v, order="C")
    return {"params": tree}


def _subtree(tree: dict, path: list):
    for p in path:
        tree = tree[p]
    return tree


def _module_leaves(model: nn.Module):
    """``(flax path, module)`` of every module holding parameters: the
    layer types below, and any module that names its own parameters in
    ``flax_leaves``."""
    kinds = (nn.Conv1d, nn.ConvTranspose1d, nn.Conv2d, nn.Linear, nn.LayerNorm, nn.GroupNorm,
             nn.BatchNorm1d, nn.BatchNorm2d, nn.Embedding, nn.PReLU)
    for name, m in model.named_modules():
        if isinstance(m, kinds) or hasattr(m, "flax_leaves"):
            yield (name.split(".") if name else []), m


def _join(path: list, attr: str) -> str:
    return ".".join(path + [attr])


def load_flax_variables(model: nn.Module, variables: dict, assign: bool = False) -> nn.Module:
    """Copy a flax variables tree (``{"params": ..., "batch_stats": ...}``,
    numpy or array leaves) into ``model`` in place. Strict both ways: every
    tensor of the model is set and every leaf of the tree is used.
    ``assign`` takes the converted arrays as the model's tensors instead of
    copying into them (a model built on the ``meta`` device)."""
    params = variables.get("params", variables)
    stats = variables.get("batch_stats", {})
    sd, used = {}, 0
    for path, m in _module_leaves(model):
        node = _subtree(params, path)
        for attr, leaf, _, from_flax in _leaf_maps(m):
            if leaf not in node:
                continue
            # torch, not numpy, makes the transposed copies (several times
            # faster on large kernels)
            sd[_join(path, attr)] = from_flax(torch.as_tensor(np.asarray(node[leaf])))
            used += 1
        if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
            s = _subtree(stats, path)
            pre = ".".join(path)
            sd[f"{pre}.running_mean"] = torch.as_tensor(np.asarray(s["mean"]))
            sd[f"{pre}.running_var"] = torch.as_tensor(np.asarray(s["var"]))
            sd[f"{pre}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
            used += 2
    n_leaves = len(_flatten(params)) + len(_flatten(stats))
    if used != n_leaves:
        raise KeyError(f"{n_leaves - used} leaves of the flax tree have no module in "
                       f"{type(model).__name__}")
    model.load_state_dict({k: v.contiguous() for k, v in sd.items()}, assign=assign)
    return model


def flax_variables(model: nn.Module) -> dict:
    """Inverse of :func:`load_flax_variables` → ``{"params": tree}`` (plus
    ``"batch_stats"`` where the model has BatchNorm), numpy leaves."""
    tree = flax_param_tree(model, dict(model.named_parameters()))
    stats: dict = {}
    for path, m in _module_leaves(model):
        if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
            node = stats
            for p in path:
                node = node.setdefault(p, {})
            node["mean"] = np.array(m.running_mean.detach().cpu().numpy(), order="C")
            node["var"] = np.array(m.running_var.detach().cpu().numpy(), order="C")
    return dict(tree, batch_stats=stats) if stats else tree


def _kernel_maps(m: nn.Module) -> tuple:
    """(flax leaf of ``m.weight``, torch → flax, flax → torch) for a layer
    of :func:`_module_leaves`."""
    if isinstance(m, nn.ConvTranspose1d):
        return ("kernel", lambda w: w.permute(2, 0, 1).flip(0),
                lambda k: k.flip(0).permute(1, 2, 0))
    if isinstance(m, nn.Conv1d):
        return "kernel", lambda w: w.permute(2, 1, 0), lambda k: k.permute(2, 1, 0)
    if isinstance(m, nn.Conv2d):
        return "kernel", lambda w: w.permute(2, 3, 1, 0), lambda k: k.permute(3, 2, 0, 1)
    if isinstance(m, nn.Linear) and hasattr(m, "flax_shapes"):
        # a DenseGeneral (the attention's projections): the kernel is the
        # Linear's [in, out] with its in or out axis split into heads
        shape = m.flax_shapes["kernel"]
        return ("kernel", lambda w: w.T.reshape(shape),
                lambda k: k.reshape(m.in_features, m.out_features).T)
    if isinstance(m, nn.Linear):
        return "kernel", lambda w: w.T, lambda k: k.T
    if isinstance(m, nn.Embedding):
        return "embedding", lambda w: w, lambda k: k
    if isinstance(m, nn.PReLU):  # flax's scalar negative_slope
        return "negative_slope", lambda w: w.reshape(()), lambda k: k.reshape(1)
    return "scale", lambda w: w, lambda k: k


def _leaf_maps(m: nn.Module) -> list:
    """``[(torch attribute, flax leaf, torch → flax, flax → torch)]`` of a
    module of :func:`_module_leaves`. A module with ``flax_leaves``
    (``{attribute: flax shape}``) holds its parameters under their flax
    names (``ActNorm``'s ``logs``/``bias``, ``InvConvNear.weight``, the
    quantizer's ``codebook``, ``pos_alpha``), reshaped between the layouts."""
    if hasattr(m, "flax_leaves"):
        return [(a, a, (lambda t, s=s: t.reshape(s)),
                 (lambda k, a=a: k.reshape(getattr(m, a).shape)))
                for a, s in m.flax_leaves.items()]
    leaf, to_flax, from_flax = _kernel_maps(m)
    out = [("weight", leaf, to_flax, from_flax)]
    if getattr(m, "bias", None) is not None:
        shape = getattr(m, "flax_shapes", {}).get("bias")
        if shape is None:
            out.append(("bias", "bias", lambda b: b, lambda b: b))
        else:
            out.append(("bias", "bias", lambda b: b.reshape(shape),
                        lambda b: b.reshape(m.bias.shape)))
    return out


#: (torch attribute, flax ``batch_stats`` leaf) of a BatchNorm's statistics
_STATS = (("running_mean", "mean"), ("running_var", "var"))


def flax_param_tree(model: nn.Module, values: dict) -> dict:
    """Tensors shaped as ``model``'s parameters, ``{parameter name:
    tensor}`` (optimizer moments), → ``{"params": tree}`` of numpy leaves in
    the layout :func:`flax_variables` gives the parameters themselves; the
    values of BatchNorm statistics (trained ones, see
    ``models.layers.train_running_stats_``) go to ``"batch_stats"``."""
    tree: dict = {}
    stats: dict = {}
    for path, m in _module_leaves(model):
        maps = [(attr, leaf, to_flax, tree) for attr, leaf, to_flax, _ in _leaf_maps(m)]
        if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
            maps += [(attr, leaf, lambda t: t, stats) for attr, leaf in _STATS]
        for attr, leaf, to_flax, node in maps:
            t = values.get(_join(path, attr))
            if t is None:
                continue
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = np.array(to_flax(t.detach()).cpu().numpy(), order="C")
    return {"params": tree, "batch_stats": stats} if stats else {"params": tree}


def param_values_from_flax(model: nn.Module, tree: dict) -> dict:
    """Inverse of :func:`flax_param_tree` → ``{parameter name: numpy array}``
    of every leaf the tree holds."""
    params = tree.get("params", tree)
    stats = tree.get("batch_stats", {})
    out = {}
    for path, m in _module_leaves(model):
        try:
            node = _subtree(params, path)
        except KeyError:
            continue
        for attr, leaf, _, from_flax in _leaf_maps(m):
            if leaf in node and not isinstance(node[leaf], dict):
                out[_join(path, attr)] = from_flax(torch.as_tensor(np.asarray(node[leaf]))).numpy()
        if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
            try:
                snode = _subtree(stats, path)
            except KeyError:
                continue
            for attr, leaf in _STATS:
                if leaf in snode:
                    out[_join(path, attr)] = np.asarray(snode[leaf])
    return {k: np.array(v, order="C") for k, v in out.items()}


def lpips_state_dict(params: dict) -> dict:
    """The flax LPIPS tree (with or without the outer ``"params"`` level)
    → ``{name: numpy array}`` for ``LPIPS.load_state_dict``."""
    tree = params.get("params", params)
    sd = {}
    for name, conv in tree["alex"].items():
        sd[f"alex.{name}.weight"] = np.asarray(conv["kernel"]).transpose(3, 2, 0, 1)
        sd[f"alex.{name}.bias"] = np.asarray(conv["bias"])
    for name, v in tree.items():
        if name != "alex":
            sd[name] = np.asarray(v)
    return {k: np.array(v, order="C") for k, v in sd.items()}


def lpips_flax_params(model: nn.Module) -> dict:
    """Inverse of :func:`lpips_state_dict` → ``{"params": tree}``."""
    alex, out = {}, {}
    for name, t in model.state_dict().items():
        v = t.detach().cpu().numpy()
        parts = name.split(".")
        if parts[0] == "alex":
            leaf = v.transpose(2, 3, 1, 0) if parts[2] == "weight" else v
            alex.setdefault(parts[1], {})["kernel" if parts[2] == "weight" else "bias"] = (
                np.array(leaf, order="C"))
        else:
            out[name] = np.array(v, order="C")
    return {"params": {"alex": alex, **out}}


def load_flax_npz(model: nn.Module, path: str) -> nn.Module:
    """:func:`load_flax_variables` from an ``.npz`` of the flattened flax
    variables (keys ``params/<module>/…/<leaf>`` and
    ``batch_stats/<module>/…/<leaf>``)."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return load_flax_variables(model, tree)


_NERF_BACKBONES = ("model_coarse", "model_fine")
_NERF_WINDOW_NETS = {"lm_encoder": ("fc1", "fc2"), "aud_net": ("fc1", "fc2"),
                     "lmatt_encoder": ("fc",), "audatt_net": ("fc",)}
_NERF_LISTS = ("lm_encoder_mlp", "color_encoder")


def nerf_flax_path(name: str) -> tuple:
    """The flax path (without the outer ``"params"``) of a vanilla NeRF
    ``state_dict`` entry, e.g. ``"model_fine.layers.8.weight"`` →
    ``("model_fine", "Dense_8", "kernel")``."""
    parts = name.split(".")
    top = parts[0]
    leaf = "kernel" if parts[-1] == "weight" else "bias"
    if top in _NERF_BACKBONES:
        return (top, f"Dense_{parts[2]}", leaf)
    if top in _NERF_LISTS:
        return (f"{top}_{parts[1]}", leaf)
    if top in _NERF_WINDOW_NETS:
        if parts[1] == "convs":
            return (top, f"Conv1dK3_{parts[2]}", leaf)
        return (top, f"Dense_{_NERF_WINDOW_NETS[top].index(parts[1])}", leaf)
    raise KeyError(f"unexpected state_dict entry {name}")


def _nerf_name(path: tuple) -> str:
    """Inverse of :func:`nerf_flax_path`."""
    attr = "weight" if path[-1] == "kernel" else "bias"
    top = path[0]
    if top in _NERF_BACKBONES:
        return f"{top}.layers.{path[1].split('_')[1]}.{attr}"
    m = re.fullmatch(r"(\w+)_(\d+)", top)
    if m and m.group(1) in _NERF_LISTS:
        return f"{m.group(1)}.{m.group(2)}.{attr}"
    if top in _NERF_WINDOW_NETS:
        kind, j = path[1].rsplit("_", 1)
        if kind == "Conv1dK3":
            return f"{top}.convs.{j}.{attr}"
        return f"{top}.{_NERF_WINDOW_NETS[top][int(j)]}.{attr}"
    raise KeyError(f"unexpected parameter {'/'.join(path)}")


def _kernel_layout(v: np.ndarray) -> np.ndarray:
    """Dense ``[in, out]`` ↔ Linear ``[out, in]``; Conv1dK3 ``[3, Cin,
    Cout]`` ↔ Conv1d ``[Cout, Cin, 3]`` (each its own inverse)."""
    return v.transpose(2, 1, 0) if v.ndim == 3 else v.T


def nerf_flax_to_state_dict(params: dict) -> dict:
    """A vanilla NeRF flax tree (with or without the outer ``"params"``)
    → ``{name: numpy array}`` for the model's ``load_state_dict``."""
    sd = {}
    for path, v in _flatten(params.get("params", params)).items():
        sd[_nerf_name(path)] = _kernel_layout(v) if path[-1] == "kernel" else v
    return {k: np.array(v, order="C") for k, v in sd.items()}


def nerf_state_dict_to_flax(values: dict) -> dict:
    """Inverse of :func:`nerf_flax_to_state_dict` (``{name: tensor or
    array}``: the parameters, or tensors of their shapes such as Adam's
    moments) → ``{"params": tree}`` of numpy leaves."""
    tree: dict = {}
    for name, t in values.items():
        v = t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)
        path = nerf_flax_path(name)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(_kernel_layout(v) if path[-1] == "kernel" else v, order="C")
    return {"params": tree}


_DEEPSPEECH_DENSE = ("1", "2", "3", "5", "6")


def deepspeech_state_dict(params: dict) -> dict:
    """The frozen graph's DeepSpeech param dict (numpy, possibly read-only
    ``np.frombuffer`` arrays) → ``{name: tensor}`` (fresh copies) for
    ``DeepSpeechNet.load_state_dict``."""
    sd = {}
    for i in _DEEPSPEECH_DENSE:
        sd[f"h{i}.weight"] = torch.tensor(np.asarray(params[f"h{i}"], np.float32).T)
        sd[f"h{i}.bias"] = torch.tensor(np.asarray(params[f"b{i}"], np.float32))
    for k in ("lstm_kernel", "lstm_bias"):
        sd[k] = torch.tensor(np.asarray(params[k], np.float32))
    return {k: v.contiguous() for k, v in sd.items()}


def deepspeech_params(model: nn.Module) -> dict:
    """Inverse of :func:`deepspeech_state_dict` → the param dict, numpy."""
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    out = {}
    for i in _DEEPSPEECH_DENSE:
        out[f"h{i}"] = np.array(sd[f"h{i}.weight"].T, order="C")
        out[f"b{i}"] = sd[f"h{i}.bias"]
    out["lstm_kernel"], out["lstm_bias"] = sd["lstm_kernel"], sd["lstm_bias"]
    return out
