"""Multi-group Adam and RMSprop (port of ``geneface_tpu/training/optim.py``
and of the optax optimizers the audio tasks build).

The JAX package chains ``optax.multi_transform`` of per-group
``scale_by_adam`` + ``scale_by_learning_rate(schedule · mult)`` behind
optional clipping, wrapped by ``apply_if_finite`` (``guard_nan_grads``).
Here the groups are the param groups of one ``torch.optim.Optimizer``
(labels from the flax paths of :mod:`geneface_tpu_torch.convert`, so they
are those of ``radnerf_label_fn``) and the step does optax's arithmetic in
its order. The update count and the finite check stay on the device: a
step whose gradients are not all finite leaves parameters, moments and
count as they were, through ``torch.where``, without a host sync.

``accumulate_grad_batches = k > 1`` is ``optax.MultiSteps`` inside
``apply_if_finite``: each micro-batch's gradients are judged alone (a
non-finite one is skipped and not accumulated), the accepted ones kept as
MultiSteps' running mean, and every k-th accepted micro-step applies Adam
(clipping included) to that mean; the other micro-steps leave the
parameters, the moments and the count as they were.

:meth:`MultiGroupAdam.state_dict` is the checkpoint's ``opt_state``: plain
numpy in the flax parameter layout (RAD-NeRF's, or with ``layout`` an audio
model's), ``{count, skipped, mu, nu}`` (plus ``mini_step`` and
``acc_grads`` when accumulating);
:meth:`~MultiGroupAdam.load_state_dict` reads it back, or the Adam state of
a JAX trainer's checkpoint (see
:func:`geneface_tpu_torch.utils.checkpoint.adam_state_from_optax`).

The audio tasks' optimizers: SyncNet and the VAE use ``optax.adam`` with the
config's betas and eps 1e-8 behind ``finalize_optimizer`` only, so no
clipping although the configs set ``clip_grad_norm`` (:func:`build_adam`);
the post-net's generator and discriminator use ``optax.rmsprop`` (decay
0.9, eps 1e-8 inside the root, initial scale 0; :class:`RMSprop`), which
``torch.optim.RMSprop`` is not (alpha 0.99, eps outside the root).
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch

from geneface_tpu_torch.convert import (
    flax_param_tree,
    flax_path,
    flax_to_state_dict,
    param_values_from_flax,
    state_dict_to_flax,
)

__all__ = [
    "radnerf_label_fn",
    "torso_label_fn",
    "param_groups",
    "MultiGroupAdam",
    "RMSprop",
    "build_adam",
    "build_optimizer",
    "build_torso_optimizer",
]


def radnerf_label_fn(path: str) -> str:
    """Group label of a '/'-joined flax parameter path."""
    if "pos_embeddings" in path or "ambient_embeddings" in path or "torso_embeddings" in path:
        return "grid"
    if "cond_att_net" in path:
        return "att"
    return "net"


def torso_label_fn(path: str) -> str:
    """Group label of a flax path in the torso task: the torso grid, the
    torso nets (and codes), and the frozen head."""
    if "torso_embeddings" in path:
        return "grid"
    if "torso" in path or "head_aware" in path:
        return "net"
    return "frozen"


def param_groups(model: torch.nn.Module, label_of_path: Callable[[str], str],
                 multipliers: Mapping[str, float],
                 path_of: Callable[[str], tuple] = flax_path) -> list:
    """One param group per label (with its lr multiplier ``mult`` and the
    ``state_dict`` names of its parameters, ``param_names``), each parameter
    labelled by its flax path ``params/...`` (``path_of``: RAD-NeRF's by
    default)."""
    groups = {name: ([], []) for name in multipliers}
    for name, p in model.named_parameters():
        label = label_of_path("/".join(("params",) + path_of(name)))
        groups[label][0].append(p)
        groups[label][1].append(name)
    return [
        {"params": ps, "name": name, "mult": float(multipliers[name]), "param_names": names}
        for name, (ps, names) in groups.items() if ps
    ]


def _multi_steps(opt: torch.optim.Optimizer, params: list, grads: list,
                 accept: torch.Tensor) -> tuple:
    """``optax.MultiSteps`` inside ``apply_if_finite`` for ``opt`` (its
    ``accumulate``, its ``mini_step`` and each parameter's ``acc`` slot):
    the running mean of the accepted micro-batches' gradients, which the
    inner optimizer applies on the ``accumulate``-th of them → (the means,
    whether this step applies them). Updates ``acc`` and ``mini_step``."""
    n = opt.mini_step.float() + 1.0
    means = []
    for p, g in zip(params, grads):
        acc = opt.state[p]["acc"]
        means.append(acc + (g - acc) / n)
    apply = accept & (opt.mini_step == opt.accumulate - 1)
    for p, m in zip(params, means):
        st = opt.state[p]
        st["acc"] = torch.where(apply, torch.zeros_like(m), torch.where(accept, m, st["acc"]))
    opt.mini_step = torch.where(accept, (opt.mini_step + 1) % opt.accumulate, opt.mini_step)
    return means, apply


class MultiGroupAdam(torch.optim.Optimizer):
    """Adam with a shared schedule times a per-group multiplier.

    ``schedule(count)`` takes the float32 update count (0 for the first
    update). ``clip_grad_value`` / ``clip_grad_norm`` clip the gradients
    first (optax ``clip`` / ``clip_by_global_norm``); ``guard_nan_grads``
    skips a step whose incoming gradients are not all finite;
    ``accumulate_grad_batches`` > 1 applies Adam to the mean of that many
    accepted micro-batches (optax ``MultiSteps``). ``layout``: the audio
    model whose flax layout (:func:`flax_param_tree`) the checkpointed
    moments take, or a ``(to_flax, from_flax)`` pair of functions (the
    vanilla NeRF's); ``None`` is RAD-NeRF's (:func:`state_dict_to_flax`).
    """

    def __init__(self, groups: list, schedule: Callable, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-15, clip_grad_norm: float = 0.0,
                 clip_grad_value: float = 0.0, guard_nan_grads: bool = True,
                 accumulate_grad_batches: int = 1,
                 layout: torch.nn.Module | tuple | None = None):
        super().__init__(groups, dict(mult=1.0))
        self.layout = layout
        self.schedule = schedule
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.clip_grad_norm = float(clip_grad_norm)
        self.clip_grad_value = float(clip_grad_value)
        self.guard_nan_grads = bool(guard_nan_grads)
        self.accumulate = int(accumulate_grad_batches)
        dev = groups[0]["params"][0].device
        #: updates applied so far (the optax ``count``), on the device
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        #: steps (micro-batches) skipped for non-finite gradients, on the device
        self.skipped = torch.zeros((), dtype=torch.int32, device=dev)
        #: accepted micro-batches since the last update (MultiSteps' ``mini_step``)
        self.mini_step = torch.zeros((), dtype=torch.int32, device=dev)

    def _slots(self, p: torch.Tensor) -> dict:
        st = self.state[p]
        if not st:
            st["mu"] = torch.zeros_like(p)
            st["nu"] = torch.zeros_like(p)
            if self.accumulate > 1:
                st["acc"] = torch.zeros_like(p)
        return st

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("MultiGroupAdam takes no closure")
        params = [p for g in self.param_groups for p in g["params"]]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        ok = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        accept = ok if self.guard_nan_grads else torch.ones_like(ok)
        if self.accumulate > 1:
            for p in params:
                self._slots(p)
            grads, apply = _multi_steps(self, params, grads, accept)
        else:
            apply = accept
        if self.clip_grad_value > 0:
            grads = [g.clamp(-self.clip_grad_value, self.clip_grad_value) for g in grads]
        if self.clip_grad_norm > 0:
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
            keep = norm < self.clip_grad_norm
            grads = [torch.where(keep, g, (g / norm) * self.clip_grad_norm) for g in grads]
        count = self.count.float()
        count_inc = count + 1.0
        bc1 = 1.0 - torch.pow(torch.full_like(count, self.b1), count_inc)
        bc2 = 1.0 - torch.pow(torch.full_like(count, self.b2), count_inc)
        lr = self.schedule(count)
        i = 0
        for group in self.param_groups:
            step_size = -(lr * group["mult"])
            for p in group["params"]:
                g = grads[i]
                i += 1
                st = self._slots(p)
                mu = (1.0 - self.b1) * g + self.b1 * st["mu"]
                nu = (1.0 - self.b2) * (g * g) + self.b2 * st["nu"]
                upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
                p.copy_(torch.where(apply, p + step_size * upd, p))
                st["mu"] = torch.where(apply, mu, st["mu"])
                st["nu"] = torch.where(apply, nu, st["nu"])
        self.count = torch.where(apply, self.count + 1, self.count)
        self.skipped = torch.where(accept, self.skipped, self.skipped + 1)

    # ------------------------------------------------------ checkpoints ----
    def _named(self) -> list:
        """``(state_dict name, parameter)`` of every parameter it updates."""
        return [(n, p) for g in self.param_groups
                for n, p in zip(g["param_names"], g["params"])]

    def _to_flax(self, values: dict) -> dict:
        if self.layout is None:
            return state_dict_to_flax(values)
        if isinstance(self.layout, tuple):
            return self.layout[0](values)
        return flax_param_tree(self.layout, values)

    def _from_flax(self, tree: dict) -> dict:
        if self.layout is None:
            return flax_to_state_dict(tree)
        if isinstance(self.layout, tuple):
            return self.layout[1](tree)
        return param_values_from_flax(self.layout, tree)

    def state_dict(self) -> dict:
        """``{count, skipped, mu, nu}`` as numpy, ``mu``/``nu`` flax trees
        ``{"params": ...}`` of the parameters it updates (plus ``mini_step``
        and the running mean ``acc_grads`` when accumulating)."""
        named = self._named()
        out = {
            "count": self.count.cpu().numpy(),
            "skipped": self.skipped.cpu().numpy(),
            "mu": self._to_flax({n: self._slots(p)["mu"] for n, p in named}),
            "nu": self._to_flax({n: self._slots(p)["nu"] for n, p in named}),
        }
        if self.accumulate > 1:
            out["mini_step"] = self.mini_step.cpu().numpy()
            out["acc_grads"] = self._to_flax({n: self._slots(p)["acc"] for n, p in named})
        return out

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict`'s output (or
        ``adam_state_from_optax``'s): every updated parameter's moments must
        be there; moments of other parameters (a JAX torso checkpoint's
        frozen head) are ignored."""
        dev = self.count.device
        trees = {k: self._from_flax(state[k]) for k in ("mu", "nu")}
        if self.accumulate > 1:
            if "acc_grads" not in state:
                raise ValueError("the checkpoint holds no accumulated gradients "
                                 f"(accumulate_grad_batches {self.accumulate})")
            trees["acc"] = self._from_flax(state["acc_grads"])
        elif "acc_grads" in state:
            raise ValueError("the checkpoint was written with accumulate_grad_batches > 1")
        for n, p in self._named():
            st = self._slots(p)
            for k, tree in trees.items():
                if n not in tree:
                    raise KeyError(f"the optimizer state holds no {k} of {n}")
                if tuple(tree[n].shape) != tuple(p.shape):
                    raise ValueError(f"{k} of {n}: {tree[n].shape} != {tuple(p.shape)}")
                st[k] = torch.as_tensor(np.asarray(tree[n]), dtype=p.dtype).to(dev)
        self.count = torch.as_tensor(np.asarray(state["count"]), dtype=torch.int32).to(dev)
        self.skipped = torch.as_tensor(np.asarray(state["skipped"]), dtype=torch.int32).to(dev)
        self.mini_step = torch.as_tensor(
            np.asarray(state.get("mini_step", 0)), dtype=torch.int32).to(dev)


def build_adam(model: torch.nn.Module, schedule: Callable, cfg) -> MultiGroupAdam:
    """SyncNet's and the VAE's optimizer, ``finalize_optimizer(optax.adam(
    schedule, b1, b2))``: one group, eps 1e-8, no clipping (optax.adam
    applies none; the configs' ``clip_grad_norm`` is unread),
    ``guard_nan_grads`` and ``accumulate_grad_batches``; moments in the
    model's flax layout."""
    names, params = zip(*[(n, p) for n, p in model.named_parameters() if p.requires_grad])
    group = {"params": list(params), "name": "all", "mult": 1.0, "param_names": list(names)}
    return MultiGroupAdam(
        [group], schedule, b1=cfg.get("optimizer_adam_beta1", 0.9),
        b2=cfg.get("optimizer_adam_beta2", 0.999), eps=1e-8,
        guard_nan_grads=cfg.get("guard_nan_grads", True),
        accumulate_grad_batches=int(cfg.get("accumulate_grad_batches", 1)), layout=model)


class RMSprop(torch.optim.Optimizer):
    """``apply_if_finite(optax.rmsprop(schedule))`` over every trainable
    parameter of ``model``: ``ν ← 0.1·g² + 0.9·ν`` from ``ν = 0``, then
    ``p ← p - schedule(count)·(g·rsqrt(ν + 1e-8))``. ``guard_nan_grads``
    skips a step whose gradients are not all finite on the device (the
    parameters, ``ν``, the count and the accumulator stay, ``skipped``
    counts it). ``accumulate_grad_batches = k > 1`` is ``optax.MultiSteps``
    inside the guard, as for :class:`MultiGroupAdam`: RMSprop moves on the
    mean of every k accepted micro-batches. :meth:`state_dict` is
    ``{count, skipped, nu}`` (plus ``mini_step`` and ``acc_grads`` when
    accumulating), ``nu`` and ``acc_grads`` in the model's flax layout;
    :meth:`load_state_dict` reads it, or
    ``utils.checkpoint.rms_state_from_optax`` of a JAX run's state."""

    #: optax.rmsprop's defaults, the post-net task's
    DECAY = 0.9
    EPS = 1e-8

    def __init__(self, model: torch.nn.Module, schedule: Callable, guard_nan_grads: bool = True,
                 accumulate_grad_batches: int = 1):
        names, params = zip(*[(n, p) for n, p in model.named_parameters() if p.requires_grad])
        super().__init__([{"params": list(params), "param_names": list(names)}], {})
        self.layout = model
        self.schedule = schedule
        self.guard_nan_grads = bool(guard_nan_grads)
        self.accumulate = int(accumulate_grad_batches)
        dev = params[0].device
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.skipped = torch.zeros((), dtype=torch.int32, device=dev)
        #: accepted micro-batches since the last update (MultiSteps' ``mini_step``)
        self.mini_step = torch.zeros((), dtype=torch.int32, device=dev)

    def _slots(self, p: torch.Tensor) -> dict:
        st = self.state[p]
        if "nu" not in st:
            st["nu"] = torch.zeros_like(p)
            if self.accumulate > 1:
                st["acc"] = torch.zeros_like(p)
        return st

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("RMSprop takes no closure")
        params = self.param_groups[0]["params"]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        ok = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        accept = ok if self.guard_nan_grads else torch.ones_like(ok)
        for p in params:
            self._slots(p)
        if self.accumulate > 1:
            grads, apply = _multi_steps(self, params, grads, accept)
        else:
            apply = accept
        step_size = -self.schedule(self.count.float())
        for p, g in zip(params, grads):
            st = self.state[p]
            nu = (1.0 - self.DECAY) * (g * g) + self.DECAY * st["nu"]
            upd = torch.rsqrt(nu + self.EPS) * g
            p.copy_(torch.where(apply, p + step_size * upd, p))
            st["nu"] = torch.where(apply, nu, st["nu"])
        self.count = torch.where(apply, self.count + 1, self.count)
        self.skipped = torch.where(accept, self.skipped, self.skipped + 1)

    def _tree(self, slot: str) -> dict:
        g = self.param_groups[0]
        return flax_param_tree(self.layout, {
            n: self._slots(p)[slot] for n, p in zip(g["param_names"], g["params"])})

    def state_dict(self) -> dict:
        out = {
            "count": self.count.cpu().numpy(),
            "skipped": self.skipped.cpu().numpy(),
            "nu": self._tree("nu"),
        }
        if self.accumulate > 1:
            out["mini_step"] = self.mini_step.cpu().numpy()
            out["acc_grads"] = self._tree("acc")
        return out

    def load_state_dict(self, state: dict) -> None:
        g = self.param_groups[0]
        dev = self.count.device
        trees = {"nu": param_values_from_flax(self.layout, state["nu"])}
        if self.accumulate > 1:
            if "acc_grads" not in state:
                raise ValueError("the checkpoint holds no accumulated gradients "
                                 f"(accumulate_grad_batches {self.accumulate})")
            trees["acc"] = param_values_from_flax(self.layout, state["acc_grads"])
        elif "acc_grads" in state:
            raise ValueError("the checkpoint was written with accumulate_grad_batches > 1")
        for n, p in zip(g["param_names"], g["params"]):
            st = self._slots(p)
            for k, tree in trees.items():
                if n not in tree:
                    raise KeyError(f"the optimizer state holds no {k} of {n}")
                if tuple(tree[n].shape) != tuple(p.shape):
                    raise ValueError(f"{k} of {n}: {tree[n].shape} != {tuple(p.shape)}")
                st[k] = torch.as_tensor(np.asarray(tree[n]), dtype=p.dtype).to(dev)
        self.count = torch.as_tensor(np.asarray(state["count"]), dtype=torch.int32).to(dev)
        self.skipped = torch.as_tensor(np.asarray(state["skipped"]), dtype=torch.int32).to(dev)
        self.mini_step = torch.as_tensor(
            np.asarray(state.get("mini_step", 0)), dtype=torch.int32).to(dev)


def build_optimizer(model: torch.nn.Module, schedule: Callable, cfg) -> MultiGroupAdam:
    """The RAD-NeRF head's optimizer: net ×1, grid ×10, att ×5, eps 1e-15,
    the config's betas, clipping and ``guard_nan_grads``."""
    groups = param_groups(model, radnerf_label_fn, {"net": 1.0, "grid": 10.0, "att": 5.0})
    return _adam_from_cfg(groups, schedule, cfg)


def _adam_from_cfg(groups: list, schedule: Callable, cfg) -> MultiGroupAdam:
    """:class:`MultiGroupAdam` with eps 1e-15 and the config's betas,
    clipping, ``guard_nan_grads`` and ``accumulate_grad_batches``."""
    return MultiGroupAdam(
        groups, schedule,
        b1=cfg.get("optimizer_adam_beta1", 0.9), b2=cfg.get("optimizer_adam_beta2", 0.999),
        eps=1e-15, clip_grad_norm=cfg.get("clip_grad_norm", 0),
        clip_grad_value=cfg.get("clip_grad_value", 0),
        guard_nan_grads=cfg.get("guard_nan_grads", True),
        accumulate_grad_batches=int(cfg.get("accumulate_grad_batches", 1)),
    )


def build_torso_optimizer(model: torch.nn.Module, schedule: Callable, cfg) -> MultiGroupAdam:
    """The torso task's optimizer: torso nets ×1, torso grid ×10, and the
    head in a ``frozen`` group with multiplier 0.

    The JAX task keeps the frozen group in its Adam with multiplier 0, so
    its head never moves. Here the frozen parameters get
    ``requires_grad_(False)`` and stay out of the optimizer instead, which
    is the same update: the head renders under no gradient, so its
    gradients are zero, its moments stay zero and its update is
    ``0·0``; and with zero gradients it cannot make ``guard_nan_grads``
    skip a step."""
    groups = param_groups(model, torso_label_fn, {"net": 1.0, "grid": 10.0, "frozen": 0.0})
    for g in groups:
        if g["mult"] == 0.0:
            for p in g["params"]:
                p.requires_grad_(False)
    return _adam_from_cfg([g for g in groups if g["mult"] != 0.0], schedule, cfg)
