"""Checkpoint IO compatible with ``geneface_tpu/utils/checkpoint.py``.

A checkpoint is one pickled dict of numpy leaves. The JAX package pickles its
``OccupancyState`` and ``TorsoOccupancyState`` NamedTuples, may pickle
flax ``FrozenDict`` nodes, and its trainer pickles optax's optimizer state
(``ApplyIfFiniteState``, ``PartitionState``, ``MaskedState``,
``ScaleByAdamState``, ``ScaleByRmsState``, ``ScaleByScheduleState``,
``MaskedNode``, ``EmptyState``, ``MultiStepsState``); the restricted
unpickler here maps
each to a plain type of the port without importing either framework, and
refuses every other global except numpy's array reconstruction helpers
(unpickling can otherwise run arbitrary code). :func:`adam_state_from_optax`
reads the Adam moments (and, from a ``MultiStepsState``, the gradient
accumulator) out of such a tree, :func:`rms_state_from_optax` the RMSprop
state of the post-net task's two optimizers.

:func:`save_checkpoint` writes plain dicts/tuples of numpy arrays in the JAX
layout — ``{"state": {"params": {"params": ...}, "occ": (density_grid,
occ_grid, mean_density)}}``, plus ``"torso_occ": (density_grid,
mean_density)`` for the torso — so the JAX ``RADNeRFInfer`` reads it as well;
the audio tasks write ``{"params": ..., "opt_state": ...}`` (SyncNet, the
VAE) and ``{"gen_params", "disc_params", "gen_opt", "disc_opt"}`` (the
post-net), as the JAX tasks do, so each package loads the other's run as a
frozen upstream.
:class:`CheckpointManager` is the JAX trainer's keep-N + best-val policy.
:func:`restore_partial` is the non-strict load of one parameter tree into
another (the torso task's warm start from a head checkpoint).
"""

from __future__ import annotations

import glob
import os
import pickle
import re
from typing import Any, NamedTuple

import numpy as np

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "get_all_checkpoints",
    "get_last_checkpoint",
    "restore_partial",
    "CheckpointManager",
    "adam_state_from_optax",
    "rms_state_from_optax",
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


# optax's state NamedTuples, by class name, with their fields (a pickled
# NamedTuple is rebuilt as ``cls.__new__(cls, *fields)``)
class ApplyIfFiniteState(NamedTuple):
    notfinite_count: Any
    last_finite: Any
    total_notfinite: Any
    inner_state: Any


class PartitionState(NamedTuple):
    inner_states: Any


class MaskedState(NamedTuple):
    inner_state: Any


class ScaleByAdamState(NamedTuple):
    count: Any
    mu: Any
    nu: Any


class ScaleByRmsState(NamedTuple):
    nu: Any


class ScaleByScheduleState(NamedTuple):
    count: Any


class MaskedNode(NamedTuple):
    """A leaf of a masked optax group's tree outside the group."""


class EmptyState(NamedTuple):
    """The state of a stateless transformation (clipping)."""


class MultiStepsState(NamedTuple):
    mini_step: Any
    gradient_step: Any
    inner_opt_state: Any
    acc_grads: Any
    skip_state: Any = ()


_OPTAX_STATES = {c.__name__: c for c in (
    ApplyIfFiniteState, PartitionState, MaskedState, ScaleByAdamState, ScaleByRmsState,
    ScaleByScheduleState, MaskedNode, EmptyState, MultiStepsState,
)}


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
        if module.split(".")[0] == "optax" and name in _OPTAX_STATES:
            return _OPTAX_STATES[name]
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


class CheckpointManager:
    """Keep-N + best-val checkpoint policy over a work dir (the JAX
    ``CheckpointManager``): :meth:`save` writes
    ``model_ckpt_steps_<step>.ckpt``, keeps the newest ``num_keep``, and,
    when ``save_best`` and ``val_metric`` improves under ``mode`` (``min``
    or ``max``), also ``model_ckpt_best.ckpt``."""

    def __init__(self, work_dir: str, num_keep: int = 2, save_best: bool = True,
                 mode: str = "min"):
        self.work_dir = work_dir
        self.num_keep = max(1, int(num_keep))
        self.save_best = bool(save_best)
        self.mode = mode
        self.best: float | None = None
        os.makedirs(work_dir, exist_ok=True)

    def _improved(self, metric: float) -> bool:
        if self.best is None:
            return True
        return metric < self.best if self.mode == "min" else metric > self.best

    def save(self, step: int, payload: dict, val_metric: float | None = None) -> str:
        path = os.path.join(self.work_dir, f"model_ckpt_steps_{step}.ckpt")
        save_checkpoint(path, payload)
        for _, old in get_all_checkpoints(self.work_dir)[: -self.num_keep]:
            os.remove(old)
        if self.save_best and val_metric is not None and self._improved(val_metric):
            self.best = float(val_metric)
            save_checkpoint(os.path.join(self.work_dir, "model_ckpt_best.ckpt"), payload)
        return path

    def restore(self, step: int | None = None) -> dict | None:
        """The checkpoint of ``step``, or with ``None``/0 the newest → its
        payload, or ``None`` when there is none."""
        if step:
            path = os.path.join(self.work_dir, f"model_ckpt_steps_{step}.ckpt")
        else:
            path = get_last_checkpoint(self.work_dir)
        if not path or not os.path.exists(path):
            return None
        return load_checkpoint(path)


def _merge_group_trees(trees: list) -> Any:
    """One tree from several of the same structure, each leaf taken from
    the tree where it is not a :class:`MaskedNode`."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _merge_group_trees([t[k] for t in trees]) for k in first}
    kept = [t for t in trees if not isinstance(t, MaskedNode)]
    if len(kept) != 1:
        raise ValueError(f"a parameter lies in {len(kept)} optax groups, not one")
    return kept[0]


def _find_partition(state: Any, path: str = "opt_state") -> tuple:
    """(``PartitionState``, ``ApplyIfFiniteState`` or ``None``,
    ``MultiStepsState`` or ``None``) inside an optax state tree of the JAX
    trainer (``apply_if_finite(MultiSteps(chain(...)))`` at most)."""
    if isinstance(state, MultiStepsState):
        part, _, _ = _find_partition(state.inner_opt_state, f"{path}.inner_opt_state")
        return part, None, state
    if isinstance(state, PartitionState):
        return state, None, None
    if isinstance(state, ApplyIfFiniteState):
        part, _, multi = _find_partition(state.inner_state, f"{path}.inner_state")
        return part, state, multi
    if isinstance(state, tuple):  # optax.chain: clipping's EmptyState first
        if any(isinstance(s, ScaleByAdamState) for s in state):  # one group: optax.adam
            return PartitionState({"all": state}), None, None
        found = [s for s in state if not isinstance(s, EmptyState)]
        if len(found) == 1:
            return _find_partition(found[0], path)
    raise ValueError(f"{path}: not an optimizer state of the JAX trainer "
                     f"({type(state).__name__})")


def adam_state_from_optax(state: Any) -> dict:
    """The JAX trainer's pickled optax state → the port's optimizer state
    ``{"count", "skipped", "mu", "nu"}`` (``mu``/``nu`` one flax tree each,
    every group's moments merged, the ``MaskedNode`` leaves skipped). Each
    group keeps its own Adam count; they must agree. ``skipped`` is
    ``ApplyIfFiniteState.total_notfinite`` (0 without the guard). A run with
    ``accumulate_grad_batches > 1`` (optax's ``MultiStepsState``) adds
    ``mini_step`` and ``acc_grads``, the accepted micro-batches since the
    last update and their running mean; its Adam state is the inner one."""
    part, guard, multi = _find_partition(state)
    adams = {}
    for name, masked in part.inner_states.items():
        inner = masked.inner_state if isinstance(masked, MaskedState) else masked
        adam = [s for s in inner if isinstance(s, ScaleByAdamState)]
        if len(adam) != 1:
            raise ValueError(f"optax group {name!r} holds no ScaleByAdamState")
        adams[name] = adam[0]
    counts = {name: int(np.asarray(a.count)) for name, a in adams.items()}
    if len(set(counts.values())) != 1:
        raise ValueError(f"the optax groups' Adam counts differ: {counts}")
    out = {
        "count": np.asarray(next(iter(counts.values())), np.int32),
        "skipped": np.asarray(0 if guard is None else guard.total_notfinite, np.int32),
        "mu": _merge_group_trees([a.mu for a in adams.values()]),
        "nu": _merge_group_trees([a.nu for a in adams.values()]),
    }
    if multi is not None:
        out["mini_step"] = np.asarray(multi.mini_step, np.int32)
        out["acc_grads"] = multi.acc_grads
    return out


def rms_state_from_optax(state: Any) -> dict:
    """A JAX post-net run's pickled ``gen_opt`` / ``disc_opt``
    (``apply_if_finite([MultiSteps(]chain(scale_by_rms,
    scale_by_learning_rate)[)])``) →
    :class:`~geneface_tpu_torch.training.optim.RMSprop`'s state ``{"count",
    "skipped", "nu"}``: the schedule's count, ``total_notfinite``, and
    ``ScaleByRmsState.nu`` (a flax tree). A run with
    ``accumulate_grad_batches > 1`` (``MultiStepsState``) adds
    ``mini_step`` and ``acc_grads``; its RMSprop state is the inner one."""
    guard = state if isinstance(state, ApplyIfFiniteState) else None
    chain = state.inner_state if guard is not None else state
    multi = chain if isinstance(chain, MultiStepsState) else None
    if multi is not None:
        chain = multi.inner_opt_state
    chain = chain if isinstance(chain, tuple) else (chain,)
    rms = [s for s in chain if isinstance(s, ScaleByRmsState)]
    sched = [s for s in chain if isinstance(s, ScaleByScheduleState)]
    if len(rms) != 1 or len(sched) != 1:
        raise ValueError(f"not an optax.rmsprop state: {[type(s).__name__ for s in chain]}")
    out = {
        "count": np.asarray(sched[0].count, np.int32),
        "skipped": np.asarray(0 if guard is None else guard.total_notfinite, np.int32),
        "nu": rms[0].nu,
    }
    if multi is not None:
        out["mini_step"] = np.asarray(multi.mini_step, np.int32)
        out["acc_grads"] = multi.acc_grads
    return out
