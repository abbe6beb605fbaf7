"""RAD-NeRF torso training task (port of ``geneface_tpu/tasks/radnerf_torso.py``).

The torso trains on a frozen head. ``build`` warm-starts the head's
parameters and occupancy from the newest checkpoint of ``head_model_dir``
(a non-strict load: :func:`restore_partial`), or marks the untrained grid
when there is none, and starts an empty 2-D torso occupancy. One step: the
torso sweep on interval steps, then the head rendered under no gradient
through the walk and the slab composite (march jitter from the task's
generator), the torso on the batch's screen coordinates, and the loss —
``torso_train_mode`` 1: MSE of the torso-over-background against
``bg_torso_img``; 2: MSE of the whole image against ``gt_img``; plus
``lambda_weights_entropy`` times the torso alpha's entropy — then Adam over
the torso nets ×1 and the torso grid ×10 (the head is frozen, see
:func:`build_torso_optimizer`). Checkpoints are in the JAX layout with
``torso_occ`` and the optimizer state in the state and ``task_step`` in the
extras; they resume as the head task's do. After each logged validation
the task renders one full head+torso val frame and logs its PSNR.

Over a mesh of ranks the step splits as the head task's does (the rays and
the head's march jitter; ``pose`` stays whole), the torso gradients are
averaged before Adam, and after each torso sweep every rank takes rank 0's
torso occupancy.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from geneface_tpu_torch import parallel
from geneface_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from geneface_tpu_torch.models.radnerf import (
    OccupancyState,
    TorsoOccupancyState,
    init_occupancy,
    init_torso_occupancy,
    mark_untrained_grid,
    model_from_cfg,
    render_rays_radnerf_torso,
    update_torso_occupancy,
)
from geneface_tpu_torch.tasks.radnerf import RADNeRFTask
from geneface_tpu_torch.training.optim import build_torso_optimizer
from geneface_tpu_torch.training.schedules import build_schedule
from geneface_tpu_torch.utils.checkpoint import (
    get_last_checkpoint,
    load_checkpoint,
    restore_partial,
)

__all__ = ["RADNeRFTorsoTask"]


class RADNeRFTorsoTask(RADNeRFTask):
    """``device`` defaults to ``cuda``; ``dtype`` is the head MLPs' compute
    dtype (the torso's compute in float32)."""

    def build(self) -> None:
        cfg = self.cfg
        seed = int(cfg.get("seed", 9999))
        dev = self.device
        self.model = model_from_cfg(cfg, torso=True, dtype=self.dtype)
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.load_datasets()
        occ = init_occupancy(self.grid_size, self.bound)
        head_dir = cfg.get("head_model_dir", "")
        if head_dir:
            path = get_last_checkpoint(head_dir) or head_dir
            head = load_checkpoint(path)["state"]
            merged = restore_partial(
                state_dict_to_flax(self.model.state_dict())["params"],
                head["params"]["params"], silent=True,
            )
            self.model.load_state_dict(
                {k: torch.as_tensor(v) for k, v in flax_to_state_dict(merged).items()}
            )
            if "occ" in head:
                occ = OccupancyState(*[torch.as_tensor(np.array(x)) for x in head["occ"]])
            print(f"| loaded head model from {path}")
        else:
            occ = mark_untrained_grid(
                occ, self.train_ds.poses, self.train_ds.intrinsics, self.grid_size, self.bound,
            )
        self.model.to(dev)
        self.set_occupancy(OccupancyState(*[x.to(dev) for x in occ]))
        self.torso_occ = init_torso_occupancy(self.grid_size, device=dev)
        self.optimizer = build_torso_optimizer(self.model, build_schedule(cfg), cfg)
        self.generator = torch.Generator(device=dev).manual_seed(seed + 1)
        self._occ_rng = np.random.RandomState(seed + 7)
        self._step = 0

    def render_kwargs(self) -> dict:
        """The head's walk-and-slab render (no lattice, no compaction)."""
        cfg = self.cfg
        return dict(
            bound=self.bound,
            min_near=float(cfg.get("min_near", 0.05)),
            dt_gamma=float(cfg.get("dt_gamma", 1.0 / 256)),
            max_steps=int(cfg.get("max_steps", 16)),
            grid_size=self.grid_size,
        )

    # -------------------------------------------------------------- loss ----
    def loss_fn(self, batch: dict, noises: torch.Tensor | None, train: bool):
        """→ (total loss, dict of scalar tensors); ``noises [N]`` jitter the
        head's march."""
        cfg = self.cfg
        model = self.model
        with torch.no_grad():
            cond_feat = model.cal_cond_feat(batch["cond_wins"])
            tables = model.grid_tables()
        codes = model.individual_embeddings
        ind = codes[min(batch["idx"], codes.shape[0] - 1)] if codes is not None else None
        t_codes = model.torso_individual_codes
        t_ind = t_codes[min(batch["idx"], t_codes.shape[0] - 1)] if t_codes is not None else None
        pose6 = batch["pose"]

        def field_fn(xyz, dirs):
            return model(xyz, dirs, cond_feat, ind, tables)

        def torso_fn(xy, head_rgb, head_ws):
            return model.forward_torso(xy, pose6, t_ind, head_rgb, head_ws)

        out = render_rays_radnerf_torso(
            field_fn, torso_fn, batch["rays_o"], batch["rays_d"], batch["bg_coords"],
            self._occ_view, self.torso_occ,
            density_thresh_torso=float(cfg.get("density_thresh_torso", 0.01)),
            bg_color=batch["bg_img"], noises=noises if train else None,
            **self.render_kwargs(),
        )
        if cfg.get("torso_train_mode", 1) == 1:
            pred, gt = out["torso_rgb_map"], batch["bg_torso_img"]
        else:
            pred, gt = out["rgb_map"], batch["gt_img"]
        mse = torch.mean((pred - gt) ** 2)
        a = out["torso_alpha_map"].clamp(1e-5, 1 - 1e-5)
        entropy = torch.mean(-a * torch.log2(a) - (1 - a) * torch.log2(1 - a))
        total = mse + cfg.get("lambda_weights_entropy", 1e-4) * entropy
        losses = {
            "torso_mse_loss": mse,
            "torso_weights_entropy_loss": entropy,
            "total_loss": total,
            "torso_psnr": -10.0 * torch.log10(mse),
            "mean_samples": out["n_samples"].float().mean(),
        }
        return total, losses

    # ------------------------------------------------------------- steps ----
    def maybe_update_occ(self) -> bool:
        """The torso sweep on every ``update_extra_interval``-th step, at the
        pose and torso code of a seeded random training frame. The head's
        occupancy stays as loaded."""
        if self._step % int(self.cfg.get("update_extra_interval", 16)):
            return False
        idx = self._occ_rng.randint(len(self.train_ds))
        model = self.model
        H = self.grid_size
        pose6 = torch.as_tensor(self.train_ds.poses6[idx : idx + 1], device=self.device)
        t_codes = model.torso_individual_codes
        t_ind = t_codes[idx % t_codes.shape[0]] if t_codes is not None else None
        with torch.no_grad(), record_function("gf::occupancy"):
            jitter = torch.rand(H * H, 2, generator=self.generator, device=self.device)
            tables = model.torso_grid_tables()
            self.torso_occ = update_torso_occupancy(
                lambda xy: model.forward_torso(xy, pose6, t_ind, tables=tables)[0][:, 0],
                self.torso_occ, jitter, grid_size=H,
            )
            if self.mesh is not None:
                parallel.broadcast_tensors(self.mesh, list(self.torso_occ))
        return True

    def state_tensors(self) -> list:
        return super().state_tensors() + list(self.torso_occ)

    def train_step(self, batch: dict) -> dict:
        """One update of the torso → the step's losses (0-d tensors)."""
        swept = self.maybe_update_occ()
        with record_function("gf::batch"):
            local, n_rays = self.split_batch(batch, "inds")
            dbatch = self.device_batch(local, self._step)
            noises = self.local_rows(
                torch.rand(n_rays, generator=self.generator, device=self.device))
        self.optimizer.zero_grad(set_to_none=True)
        total, losses = self.loss_fn(dbatch, noises, train=True)
        with record_function("gf::backward"):
            total.backward()
        with record_function("gf::optim"):
            self.sync_grads(self.model.parameters())
            losses["grad_norm"] = torch.sqrt(sum(
                (p.grad.float() ** 2).sum() for p in self.model.parameters()
                if p.grad is not None
            ))
            self.optimizer.step()
        if self.mesh is not None:
            losses = self.reduce_metrics(losses)
            losses["torso_psnr"] = -10.0 * torch.log10(losses["torso_mse_loss"])
        self._step += 1
        losses = {k: v.detach() for k, v in losses.items()}
        losses["occupancy_sweep"] = float(swept)
        return losses

    @torch.no_grad()
    def render_full_frame(self, ds=None, idx: int = 0) -> tuple:
        """All H·W rays of frame ``idx``: the head (the walk, unjittered)
        over the torso at the frame's pose and torso code over the
        background → (image [H, W, 3], ground truth [H, W, 3]), float
        numpy."""
        ds = ds or self.val_ds
        model = self.model
        dev = self.device
        rays_o, rays_d, cond, gt = self.frame_inputs(ds, idx)
        cond_feat = model.cal_cond_feat(cond)
        codes = model.individual_embeddings
        ind = codes[0] if codes is not None else None
        t_codes = model.torso_individual_codes
        t_ind = t_codes[idx % t_codes.shape[0]] if t_codes is not None else None
        pose6 = torch.as_tensor(ds.poses6[idx : idx + 1], device=dev)
        out = render_rays_radnerf_torso(
            lambda xyz, dirs: model(xyz, dirs, cond_feat, ind),
            lambda xy, head_rgb, head_ws: model.forward_torso(xy, pose6, t_ind, head_rgb, head_ws),
            rays_o, rays_d, torch.as_tensor(ds.bg_coords, device=dev), self._occ_view,
            self.torso_occ, density_thresh_torso=float(self.cfg.get("density_thresh_torso", 0.01)),
            bg_color=torch.as_tensor(ds.bg_img.reshape(-1, 3), device=dev),
            **self.render_kwargs(),
        )
        return out["rgb_map"].float().cpu().numpy().reshape(ds.H, ds.W, 3), gt

    def checkpoint_payload(self, step: int) -> dict:
        payload = super().checkpoint_payload(step)
        payload["state"]["torso_occ"] = tuple(self.torso_occ)
        return payload

    def restore_state(self, state: dict) -> None:
        super().restore_state(state)
        self.torso_occ = TorsoOccupancyState(
            *[torch.as_tensor(np.asarray(x), device=self.device) for x in state["torso_occ"]])
