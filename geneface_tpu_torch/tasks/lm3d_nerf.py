"""Vanilla (AD-NeRF-style) NeRF training tasks (port of
``geneface_tpu/tasks/lm3d_nerf.py``): :class:`Lm3dNeRFTask` and
:class:`ADNeRFTask` for the head, :class:`Lm3dNeRFTorsoTask` and
:class:`ADNeRFTorsoTask` for the torso on a frozen head.

One head step: a batch of ``n_rays`` rays (most inside the face rect), the
coarse and fine render (``ops.volume.render_rays``, jittered with noise from
the task's seeded ``torch.Generator`` on the device), MSE plus the coarse
MSE, ``backward`` and Adam. The attention warm start is the JAX task's:
before ``no_smo_iterations`` the condition is the frame's own window
without the attention net, after it the ``smo_win_size`` window with it.

The optimizer is the JAX task's ``multi_transform`` of two Adam groups over
the flax paths: ``net`` ×1 and ``att`` ×5 (the attention net), Adam eps 1e-8
(optax's ``scale_by_adam`` default), the config's schedule, no clipping,
``guard_nan_grads`` and ``accumulate_grad_batches``. Checkpoints hold the
parameters and the optimizer state in the flax layout
(``convert.nerf_state_dict_to_flax``) and ``task_step``;
:meth:`~Lm3dNeRFTask.restore_state` reads the port's and the JAX trainer's.

The torso task renders the frozen head at the frame's pose without jitter
and under ``torch.no_grad`` (the JAX task's stop-gradient, in less memory),
and trains the torso field at the canonical pose on the composite
``head · last_weight_torso + rgb_fg_torso``. As in the JAX package (its
documented divergence from the reference), the lm3d torso is conditioned on
its own lm3d windows, not on DeepSpeech.

Over a mesh of ranks each rank renders its rows of ``data_batch_keys`` (the
JAX task's per-ray leaves) with its rows of ``t_rand`` and ``u``, drawn at
the global ray count from the shared generator; the gradients are averaged
over the ranks before Adam and the step metrics reduced.
"""

from __future__ import annotations

import numpy as np
import torch

from geneface_tpu_torch import resolve_device
from geneface_tpu_torch.convert import (
    nerf_flax_path,
    nerf_flax_to_state_dict,
    nerf_state_dict_to_flax,
)
from geneface_tpu_torch.data.nerf_dataset import NeRFDataset
from geneface_tpu_torch.models.nerf import ADNeRF, ADNeRFTorso, Lm3dNeRF
from geneface_tpu_torch.ops.volume import render_rays
from geneface_tpu_torch.training.optim import MultiGroupAdam, param_groups
from geneface_tpu_torch.training.schedules import build_schedule
from geneface_tpu_torch.training.trainer import Task
from geneface_tpu_torch.utils.checkpoint import (
    adam_state_from_optax,
    get_last_checkpoint,
    load_checkpoint,
    restore_partial,
)

__all__ = [
    "Lm3dNeRFTask",
    "ADNeRFTask",
    "Lm3dNeRFTorsoTask",
    "ADNeRFTorsoTask",
    "cond_in_dim",
    "head_label_fn",
    "torso_label_fn",
]


def cond_in_dim(cfg) -> int:
    """The condition's per-frame width, as the dataset reads it by
    ``cond_type``: DeepSpeech 29, esperanto 44, else the lm3d's 204."""
    return {"deepspeech": 29, "esperanto": 44}.get(
        cfg.get("cond_type", "idexp_lm3d_normalized"), 68 * 3)


def head_label_fn(path: str) -> str:
    """The head's Adam group of a flax path: the attention nets ×5."""
    return "att" if ("att" in path and "encoder" in path) or "audatt" in path else "net"


def torso_label_fn(path: str) -> str:
    """The torso's Adam group of a flax path: the attention net ×5."""
    return "att" if "audatt" in path else "net"


def nerf_adam(model: torch.nn.Module, label_fn, cfg) -> MultiGroupAdam:
    """Adam groups ``net`` ×1 and ``att`` ×5 over ``model``'s parameters,
    eps 1e-8, the config's betas and schedule, no clipping; moments in the
    vanilla flax layout."""
    return MultiGroupAdam(
        param_groups(model, label_fn, {"net": 1.0, "att": 5.0}, path_of=nerf_flax_path),
        build_schedule(cfg),
        b1=cfg.get("optimizer_adam_beta1", 0.9), b2=cfg.get("optimizer_adam_beta2", 0.999),
        eps=1e-8, guard_nan_grads=cfg.get("guard_nan_grads", True),
        accumulate_grad_batches=int(cfg.get("accumulate_grad_batches", 1)),
        layout=(nerf_state_dict_to_flax, nerf_flax_to_state_dict),
    )


def load_nerf_params(model: torch.nn.Module, params: dict) -> None:
    """A flax tree (``{"params": ...}`` or bare) into ``model``, strictly."""
    model.load_state_dict(
        {k: torch.as_tensor(v) for k, v in nerf_flax_to_state_dict(params).items()})


def data_dir_of(cfg) -> str:
    return cfg.get("data_dir") or (
        f"{cfg.get('binary_data_dir', 'data/binary/videos')}/{cfg.get('video_id', '')}")


def psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / np.log(10.0)


class Lm3dNeRFTask(Task):
    """``device`` defaults to ``cuda``; the models compute in float32."""

    #: the batch keys the loss reads
    batch_keys = ("rays_o", "rays_d", "gt_img", "bg_img", "cond", "cond_wins")
    #: the per-ray ones among them (the JAX task's)
    data_batch_keys = ("rays_o", "rays_d", "gt_img", "bg_img")

    def __init__(self, cfg, device=None):
        super().__init__(cfg)
        self.device = resolve_device(device)

    def make_model(self) -> torch.nn.Module:
        cfg = self.cfg
        return Lm3dNeRF(
            dim_in=cond_in_dim(cfg),
            cond_dim=cfg.get("cond_dim", 64),
            hidden_size=cfg.get("hidden_size", 256),
            use_window_cond=cfg.get("use_window_cond", True),
            cond_win_size=cfg.get("cond_win_size", 1),
            smo_win_size=cfg.get("smo_win_size", 5),
            with_att=cfg.get("with_att", True),
        )

    @classmethod
    def run_inference(cls, cfg, device=None) -> str:
        """``--infer``: the predicted lm3d ``.npy`` (``infer_cond_name``)
        through :class:`~geneface_tpu_torch.inference.nerf_infer.LM3dNeRFInfer`
        to the mp4 (``infer_out_video_name``) → its path."""
        from geneface_tpu_torch.inference.nerf_infer import LM3dNeRFInfer

        return LM3dNeRFInfer(cfg, device=device).run(
            cfg["infer_cond_name"],
            out_path=cfg.get("infer_out_video_name") or "infer_out/out.mp4",
            audio_path=cfg.get("infer_audio_source_name") or None,
            n_frames=cfg.get("infer_n_frames") or None,
        )

    # ------------------------------------------------------------- build ----
    def build(self) -> None:
        cfg = self.cfg
        seed = int(cfg.get("seed", 9999))
        self.model = self.make_model()
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        self.train_ds = NeRFDataset("train", data_dir_of(cfg), cfg, training=True)
        self.val_ds = NeRFDataset("val", data_dir_of(cfg), cfg, training=True)
        self.optimizer = nerf_adam(self.model, head_label_fn, cfg)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self._step = 0

    def render_kwargs(self) -> dict:
        cfg = self.cfg
        return dict(near=cfg.get("near", 0.3), far=cfg.get("far", 0.9),
                    n_samples=int(cfg.get("n_samples_per_ray", 16)),
                    n_importance=int(cfg.get("n_samples_per_ray_fine", 16)))

    def with_att(self) -> bool:
        """The attention net runs from ``no_smo_iterations`` on."""
        return bool(self.cfg.get("with_att", True)) and self._step >= int(
            self.cfg.get("no_smo_iterations", 0))

    def device_batch(self, batch: dict) -> dict:
        """The loss's numpy arrays → float32 tensors on the device."""
        return {k: torch.as_tensor(np.asarray(batch[k], np.float32), device=self.device)
                for k in self.batch_keys}

    def draw_noise(self, n_rays: int) -> dict:
        """The step's jitter ``t_rand`` and importance draws ``u`` for
        ``n_rays`` global rays, from the task's generator → this rank's
        rows."""
        kw = self.render_kwargs()
        dev, g = self.device, self.generator
        return {k: self.local_rows(torch.rand(n_rays, kw[n], generator=g, device=dev))
                for k, n in (("t_rand", "n_samples"), ("u", "n_importance"))}

    # -------------------------------------------------------------- loss ----
    def loss_fn(self, batch: dict, noise: dict | None, with_att: bool):
        """→ (total loss, dict of 0-d tensors); ``noise`` (from
        :meth:`draw_noise`) jitters the render, ``None`` renders it
        deterministically (validation)."""
        model = self.model
        cond = batch["cond_wins"] if with_att else batch["cond"]
        cond_feat = model.cal_cond_feat(cond, with_att)
        rd = batch["rays_d"]
        viewdirs = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
        out = render_rays(
            lambda pts, fine: model(pts, cond_feat, viewdirs, fine),
            batch["rays_o"], rd, bc_rgb=batch["bg_img"], **self.render_kwargs(),
            **(noise or {}),
        )
        gt = batch["gt_img"]
        mse = torch.mean((out["rgb_map"] - gt) ** 2)
        losses = {"mse_loss": mse}
        if "rgb_map_coarse" in out:
            losses["mse_loss_coarse"] = torch.mean((out["rgb_map_coarse"] - gt) ** 2)
        total = sum(losses.values())
        losses["total_loss"] = total
        losses["psnr"] = psnr(mse)
        return total, losses

    # ------------------------------------------------------------- steps ----
    def trainable(self) -> torch.nn.Module:
        return self.model

    def train_step(self, batch: dict) -> dict:
        """One update → the step's losses (0-d tensors on the device)."""
        local, n_rays = self.split_batch(batch, "rays_o")
        dbatch = self.device_batch(local)
        noise = self.draw_noise(n_rays)
        self.optimizer.zero_grad(set_to_none=True)
        total, losses = self.loss_fn(dbatch, noise, self.with_att())
        total.backward()
        self.sync_grads(self.trainable().parameters())
        self.optimizer.step()
        self._step += 1
        if self.mesh is not None:
            losses = self.reduce_metrics(losses)
            for k in ("psnr", "com_psnr"):
                if k in losses:
                    losses[k] = psnr(losses["mse_loss" if k == "psnr" else "com_mse_loss"])
        return {k: v.detach() for k, v in losses.items()}

    @torch.no_grad()
    def val_step(self, batch: dict) -> dict:
        return self.loss_fn(self.device_batch(batch), None, self.with_att())[1]

    # -------------------------------------------------------------- data ----
    def train_batches(self, start_step: int = 0):
        self._step = start_step
        return self.train_ds.iter_epochs(start_step)

    def val_batches(self):
        for i in range(len(self.val_ds)):
            yield self.val_ds[i]

    # ------------------------------------------------------ checkpoints ----
    def on_save(self) -> dict:
        return {"task_step": self._step}

    def on_restore(self, extra: dict) -> None:
        self._step = int(extra.get("task_step", self._step))

    def checkpoint_payload(self, step: int) -> dict:
        """The trained model's parameters and the optimizer state in the
        JAX checkpoint layout, the step and ``task_step``."""
        return {
            "state": {"params": nerf_state_dict_to_flax(self.trainable().state_dict()),
                      "opt_state": self.optimizer.state_dict()},
            "step": int(step),
            "extra": self.on_save(),
        }

    def restore_state(self, state: dict) -> None:
        """Parameters and optimizer state written by the port or by the JAX
        trainer (optax's state tree)."""
        load_nerf_params(self.trainable(), state["params"])
        opt = state["opt_state"]
        self.optimizer.load_state_dict(opt if isinstance(opt, dict)
                                       else adam_state_from_optax(opt))


class ADNeRFTask(Lm3dNeRFTask):
    """The DeepSpeech-conditioned head."""

    def make_model(self) -> torch.nn.Module:
        cfg = self.cfg
        return ADNeRF(dim_in=cond_in_dim(cfg), cond_dim=cfg.get("cond_dim", 64),
                      hidden_size=cfg.get("hidden_size", 256))

    @classmethod
    def run_inference(cls, cfg, device=None) -> str:
        """``--infer``: a ``[T, 16, 29]`` DeepSpeech ``.npy``
        (``infer_cond_name``) through
        :class:`~geneface_tpu_torch.inference.nerf_infer.ADNeRFInfer` to the
        mp4 → its path."""
        from geneface_tpu_torch.inference.nerf_infer import ADNeRFInfer

        return ADNeRFInfer(cfg, device=device).run(
            cfg["infer_cond_name"],
            out_path=cfg.get("infer_out_video_name") or "infer_out/out.mp4",
            audio_path=cfg.get("infer_audio_source_name") or None,
            n_frames=cfg.get("infer_n_frames") or None,
        )


class Lm3dNeRFTorsoTask(Lm3dNeRFTask):
    """The torso on the frozen head of ``head_model_dir`` (its newest
    checkpoint, read non-strictly; without it the head stays at its seeded
    init)."""

    batch_keys = ("rays_o", "rays_d", "rays_o_head", "rays_d_head", "gt_img", "bg_img",
                  "cond", "cond_wins", "euler", "trans")
    data_batch_keys = ("rays_o", "rays_d", "rays_o_head", "rays_d_head", "gt_img", "bg_img")

    def make_torso_model(self) -> torch.nn.Module:
        cfg = self.cfg
        return ADNeRFTorso(
            dim_in=cond_in_dim(cfg), cond_dim=cfg.get("cond_dim", 64),
            hidden_size=cfg.get("hidden_size", 256), use_color=cfg.get("use_color", True),
            cond_win_size=cfg.get("cond_win_size", 1), smo_win_size=cfg.get("smo_win_size", 5),
        )

    def use_color(self) -> bool:
        return bool(self.cfg.get("use_color", True))

    def build(self) -> None:
        cfg = self.cfg
        seed = int(cfg.get("seed", 9999))
        self.model = self.make_model()  # the frozen head
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        head_dir = cfg.get("head_model_dir", "")
        path = get_last_checkpoint(head_dir) if head_dir else None
        if path:
            mine = nerf_state_dict_to_flax(self.model.state_dict())
            load_nerf_params(self.model, restore_partial(
                mine, load_checkpoint(path)["state"]["params"]))
        self.model.requires_grad_(False)
        self.model.to(self.device)
        self.torso_model = self.make_torso_model()
        self.torso_model.reset_parameters(torch.Generator().manual_seed(seed + 1))
        self.torso_model.to(self.device)
        self.train_ds = NeRFDataset("train", data_dir_of(cfg), cfg, training=True)
        self.val_ds = NeRFDataset("val", data_dir_of(cfg), cfg, training=True)
        self.optimizer = nerf_adam(self.torso_model, torso_label_fn, cfg)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 2)
        self._step = 0

    def trainable(self) -> torch.nn.Module:
        return self.torso_model

    @torch.no_grad()
    def render_head(self, batch: dict, with_att: bool) -> dict:
        """The frozen head at the frame's pose, unjittered."""
        head = self.model
        cond = batch["cond_wins"] if with_att else batch["cond"]
        feat = head.cal_cond_feat(cond, with_att)
        rd = batch["rays_d_head"]
        vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
        return render_rays(lambda pts, fine: head(pts, feat, vd, fine), batch["rays_o_head"],
                           rd, bc_rgb=batch["bg_img"], **self.render_kwargs())

    def loss_fn(self, batch: dict, noise: dict | None, with_att: bool):
        torso = self.torso_model
        head_out = self.render_head(batch, with_att)
        feat = torso.cal_cond_feat(
            batch["cond_wins"], batch["euler"], batch["trans"],
            color=head_out["rgb_map"] if self.use_color() else None, with_att=True,
        )
        rd = batch["rays_d"]
        vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
        out = render_rays(
            lambda pts, fine: torso(pts, feat, vd, fine), batch["rays_o"], rd,
            bc_rgb=batch["bg_img"], **self.render_kwargs(), **(noise or {}),
        )
        gt = batch["gt_img"]
        rgb_com = head_out["rgb_map"] * out["last_weight"][:, None] + out["rgb_map_fg"]
        mse = torch.mean((rgb_com - gt) ** 2)
        losses = {"com_mse_loss": mse}
        if "rgb_map_coarse" in out and "rgb_map_coarse" in head_out:
            rgb_com0 = head_out["rgb_map_coarse"] * out["last_weight0"][:, None] + out["rgb_map_fg0"]
            losses["com_mse_loss_coarse"] = torch.mean((rgb_com0 - gt) ** 2)
        total = sum(losses.values())
        losses["total_loss"] = total
        losses["com_psnr"] = psnr(mse)
        return total, losses

    def train_batches(self, start_step: int = 0):
        self._step = start_step
        return self.train_ds.iter_torso_epochs(start_step)

    def val_batches(self):
        for i in range(len(self.val_ds)):
            yield self.val_ds.get_torso_item(i)


class ADNeRFTorsoTask(Lm3dNeRFTorsoTask):
    """The DeepSpeech-conditioned torso."""

    run_inference = ADNeRFTask.run_inference
    make_model = ADNeRFTask.make_model

    def use_color(self) -> bool:
        return bool(self.cfg.get("use_color", False))

    def make_torso_model(self) -> torch.nn.Module:
        cfg = self.cfg
        return ADNeRFTorso(
            dim_in=cond_in_dim(cfg), cond_dim=cfg.get("cond_dim", 64),
            hidden_size=cfg.get("hidden_size", 256), use_color=self.use_color(),
            cond_win_size=16, smo_win_size=cfg.get("smo_win_size", 8),
        )
