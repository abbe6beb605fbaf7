"""Checkpoint IO compatible with ``geneface_tpu/utils/checkpoint.py``.

A checkpoint is one pickled dict of numpy leaves. The JAX package pickles its
``OccupancyState`` and ``TorsoOccupancyState`` NamedTuples and may pickle
flax ``FrozenDict`` nodes; the
restricted unpickler here maps both to the port's plain types without
importing either framework, and refuses every other global except numpy's
array reconstruction helpers (unpickling can otherwise run arbitrary code).

:func:`save_checkpoint` writes plain dicts/tuples of numpy arrays in the JAX
layout — ``{"state": {"params": {"params": ...}, "occ": (density_grid,
occ_grid, mean_density)}}``, plus ``"torso_occ": (density_grid,
mean_density)`` for the torso — so the JAX ``RADNeRFInfer`` reads it as well.
:func:`restore_partial` is the non-strict load of one parameter tree into
another (the torso task's warm start from a head checkpoint).
"""

from __future__ import annotations

import glob
import os
import pickle
import re
from typing import Any

import numpy as np

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "get_all_checkpoints",
    "get_last_checkpoint",
    "save_step_checkpoint",
    "restore_partial",
]

_STEP_RE = re.compile(r"model_ckpt_steps_(\d+)\.ckpt$")

_NUMPY_GLOBALS = {
    (mod, name)
    for mod in (
        "numpy", "numpy.core.multiarray", "numpy._core.multiarray",
        "numpy.core.numeric", "numpy._core.numeric",
    )
    for name in ("ndarray", "dtype", "_reconstruct", "_frombuffer", "scalar")
}


def _as_dict(mapping=None):
    return dict(mapping or {})


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str) -> Any:
        from geneface_tpu_torch.models.radnerf import renderer

        if (module, name) in _NUMPY_GLOBALS or (
            module == "numpy.dtypes" and name.endswith("DType")
        ):
            return super().find_class(module, name)
        if name in ("OccupancyState", "TorsoOccupancyState") and module.endswith(
                "models.radnerf.renderer"):
            return getattr(renderer, name)
        if (module, name) == ("flax.core.frozen_dict", "FrozenDict"):
            return _as_dict
        raise pickle.UnpicklingError(
            f"checkpoint refers to {module}.{name}, which the loader does not allow"
        )


def _plain(tree: Any) -> Any:
    """Nested dicts/tuples/lists of numpy arrays (tensors moved to the host)."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_plain(v) for v in tree)
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy()
    if isinstance(tree, (int, float, str, bool)) or tree is None:
        return tree
    return np.asarray(tree)


def save_checkpoint(path: str, payload: dict) -> None:
    """Atomically pickle ``payload`` as plain numpy containers."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".part"
    with open(tmp, "wb") as f:
        pickle.dump(_plain(payload), f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()


def get_all_checkpoints(work_dir: str) -> list:
    """``(step, path)`` of every ``model_ckpt_steps_<step>.ckpt`` under
    ``work_dir``, by step."""
    found = []
    for p in glob.glob(os.path.join(work_dir, "model_ckpt_steps_*.ckpt")):
        m = _STEP_RE.search(p)
        if m:
            found.append((int(m.group(1)), p))
    return sorted(found)


def get_last_checkpoint(work_dir: str) -> str | None:
    """Newest ``model_ckpt_steps_<step>.ckpt`` under ``work_dir``."""
    found = get_all_checkpoints(work_dir)
    return found[-1][1] if found else None


def save_step_checkpoint(work_dir: str, step: int, payload: dict, num_keep: int = 1) -> str:
    """Write ``model_ckpt_steps_<step>.ckpt`` and keep the newest
    ``num_keep`` step checkpoints (the JAX ``CheckpointManager`` rotation)."""
    path = os.path.join(work_dir, f"model_ckpt_steps_{step}.ckpt")
    save_checkpoint(path, payload)
    for _, old in get_all_checkpoints(work_dir)[: -max(1, int(num_keep))]:
        os.remove(old)
    return path


def restore_partial(target: dict, source: dict, silent: bool = False) -> dict:
    """Copy the leaves of the nested dict ``source`` into a copy of
    ``target`` where both have the key (the non-strict load). Leaves whose
    shapes differ are skipped, with a message unless ``silent``; keys
    missing from ``source`` keep ``target``'s leaf."""

    def merge(dst: Any, src: Any, path: str) -> Any:
        if isinstance(dst, dict):
            if not isinstance(src, dict):
                return dst
            return {
                k: merge(v, src[k], f"{path}.{k}" if path else k) if k in src else v
                for k, v in dst.items()
            }
        arr = np.asarray(src)
        if tuple(arr.shape) != tuple(np.shape(dst)):
            if not silent:
                print(f"| skip {path}: ckpt {arr.shape} != model {np.shape(dst)}")
            return dst
        return arr

    return merge(target, source, "")
