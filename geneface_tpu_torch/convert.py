"""Flax parameter tree (numpy leaves) ↔ the port's ``state_dict``.

The JAX checkpoints hold ``{"params": {...}}`` trees of the flax RAD-NeRF.
The mapping, module by module:

- grid tables ``{pos,ambient}_embeddings/group_<i>`` are kept as they are;
- ``Conv1dK3_<j>``: kernel ``[3, Cin, Cout]`` → ``convs.<j>.weight``
  ``[Cout, Cin, 3]`` (``Conv1d`` layout), bias as it is;
- ``AudioNet`` ``Dense_0/1`` → ``fc1``/``fc2``, ``AudioAttNet`` ``Dense_0``
  → ``fc`` (kernel ``[in, out]`` → ``weight [out, in]``, with bias);
- the bias-free MLP layers ``Dense_<i>/kernel`` (``_SplitDense`` and the
  ``_KernelHolder`` of split heads alike) → ``layers.<i>.weight``;
- ``individual_embeddings`` as it is.
"""

from __future__ import annotations

import re

import numpy as np

__all__ = ["flax_to_state_dict", "state_dict_to_flax"]

_AUDIO_DENSE = {
    ("cond_prenet", "Dense_0"): "fc1",
    ("cond_prenet", "Dense_1"): "fc2",
    ("cond_att_net", "Dense_0"): "fc",
}
_AUDIO_DENSE_INV = {v: k[1] for k, v in _AUDIO_DENSE.items()}


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
        if top in ("pos_embeddings", "ambient_embeddings"):
            sd[f"{top}.{path[1]}"] = v
        elif top == "individual_embeddings":
            sd[top] = v
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
        elif top in ("ambient_net", "sigma_net", "color_net"):
            i = re.fullmatch(r"Dense_(\d+)", path[1]).group(1)
            sd[f"{top}.layers.{i}.weight"] = v.T
        else:
            raise KeyError(f"unexpected parameter {'/'.join(path)}")
    return {k: np.array(v, order="C") for k, v in sd.items()}


def state_dict_to_flax(state_dict: dict) -> dict:
    """Inverse of :func:`flax_to_state_dict` → ``{"params": tree}``."""
    tree: dict = {}

    def put(path, value):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(value, order="C")

    for name, t in state_dict.items():
        v = t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)
        parts = name.split(".")
        top = parts[0]
        if top in ("pos_embeddings", "ambient_embeddings"):
            put((top, parts[1]), v)
        elif top == "individual_embeddings":
            put((top,), v)
        elif top in ("cond_prenet", "cond_att_net") and parts[1] == "convs":
            leaf = "kernel" if parts[3] == "weight" else "bias"
            put((top, f"Conv1dK3_{parts[2]}", leaf), v.transpose(2, 1, 0) if leaf == "kernel" else v)
        elif top in ("cond_prenet", "cond_att_net"):
            leaf = "kernel" if parts[2] == "weight" else "bias"
            put((top, _AUDIO_DENSE_INV[parts[1]], leaf), v.T if leaf == "kernel" else v)
        elif top in ("ambient_net", "sigma_net", "color_net"):
            put((top, f"Dense_{parts[2]}", "kernel"), v.T)
        else:
            raise KeyError(f"unexpected state_dict entry {name}")
    return {"params": tree}
