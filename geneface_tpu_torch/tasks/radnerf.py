"""RAD-NeRF head training task (port of ``geneface_tpu/tasks/radnerf.py``).

One step: the occupancy sweep on interval steps, the jittered compact
render of a random ray batch, the losses (MSE + weights entropy + the
ambient loss ramped over 250k steps), ``backward`` and the multi-group Adam
update. Like the JAX task it re-picks the sample capacity and the lattice
budget from the measured mean samples per ray and march span (one host
read on the first step and every ``capacity_check_interval`` steps), from
the same buckets, so the same samples are dropped.

The task owns its state: the model, the optimizer and the occupancy grids.
Supported: the fused grid backend, the lattice march with compaction
(``march_backend: lattice``, ``mean_samples_per_ray > 0``), one device.
The lip fine-tune phase (LPIPS) is not ported: ``finetune_lips: true``
raises. Noise comes from the task's seeded ``torch.Generator`` on the
device and reaches the renderer and the sweep as tensors.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from geneface_tpu_torch import resolve_device
from geneface_tpu_torch.convert import state_dict_to_flax
from geneface_tpu_torch.data.radnerf_dataset import RADNeRFDataset, get_cond_window
from geneface_tpu_torch.models.radnerf import (
    init_occupancy,
    mark_untrained_grid,
    model_from_cfg,
    occupancy_view,
    render_rays_radnerf,
    update_extra_state,
)
from geneface_tpu_torch.training.optim import build_optimizer
from geneface_tpu_torch.training.schedules import build_schedule
from geneface_tpu_torch.training.trainer import Task
from geneface_tpu_torch.utils.camera import bg_coords_device, get_rays_device

__all__ = ["RADNeRFTask"]


class RADNeRFTask(Task):
    """``device`` defaults to ``cuda``; ``dtype`` is the field MLPs' compute
    dtype (bf16, as the JAX model's default); the grids compute in f32."""

    #: sample-capacity buckets (mean samples per ray) and lattice budgets
    #: of the JAX task
    SPR_BUCKETS = (2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 10.0, 12.0, 16.0)
    LATK_BUCKETS = (16, 24, 32, 48, 64, 96, 128)

    def __init__(self, cfg, device=None, dtype: torch.dtype = torch.bfloat16):
        super().__init__(cfg)
        self.device = resolve_device(device)
        self.dtype = dtype

    @classmethod
    def run_inference(cls, cfg, device=None) -> str:
        """``--infer``: the predicted lm3d ``.npy`` of stage A
        (``infer_cond_name``; without it the dataset's own conditions) →
        the rendered mp4 (``infer_out_video_name``) with the audio
        (``infer_audio_source_name``) muxed in → its path."""
        from geneface_tpu_torch.inference.radnerf_infer import RADNeRFInfer

        infer = RADNeRFInfer(cfg, device=device)
        cond_name = cfg.get("infer_cond_name", "")
        lm3d = np.load(cond_name).reshape(-1, 68, 3) if cond_name else None
        return infer.render_video(
            lm3d,
            out_path=cfg.get("infer_out_video_name") or "infer_out/out.mp4",
            audio_path=cfg.get("infer_audio_source_name") or None,
            n_frames=cfg.get("infer_n_frames") or None,
        )

    # ------------------------------------------------------------- build ----
    def build(self) -> None:
        cfg = self.cfg
        if cfg.get("finetune_lips", True):
            raise NotImplementedError(
                "finetune_lips: the lip phase needs LPIPS, which is not ported yet"
            )
        if cfg.get("march_backend", "lattice") != "lattice" or not cfg.get(
            "mean_samples_per_ray", 8
        ):
            raise NotImplementedError(
                "the port trains through the lattice march + compact path only "
                "(march_backend: lattice, mean_samples_per_ray > 0)"
            )
        seed = int(cfg.get("seed", 9999))
        dev = self.device
        self.model = model_from_cfg(cfg, dtype=self.dtype)
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(dev)
        self.load_datasets()
        occ = init_occupancy(self.grid_size, self.bound, device=dev)
        self.set_occupancy(mark_untrained_grid(
            occ, self.train_ds.poses, self.train_ds.intrinsics, self.grid_size, self.bound,
        ))
        self.optimizer = build_optimizer(self.model, build_schedule(cfg), cfg)
        self.generator = torch.Generator(device=dev).manual_seed(seed + 1)
        self._occ_rng = np.random.RandomState(seed + 7)
        self._step = 0
        self._spr_bucket = None  # None -> the config's mean_samples_per_ray
        self._latk_bucket = None  # None -> the config's lattice_K
        self._checked = False

    def load_datasets(self) -> None:
        """The train and val splits of the config's video, and the grid
        geometry."""
        cfg = self.cfg
        data_dir = cfg.get("binary_data_dir", "data/binary/videos")
        video_id = cfg.get("video_id", "")
        ds_dir = cfg.get("data_dir") or (f"{data_dir}/{video_id}" if video_id else data_dir)
        self.train_ds = RADNeRFDataset("train", ds_dir, cfg, training=True)
        self.val_ds = RADNeRFDataset("val", ds_dir, cfg, training=True)
        self.grid_size = int(cfg.get("grid_size", 128))
        self.bound = float(cfg.get("bound", 1))

    def set_occupancy(self, occ) -> None:
        """Install an occupancy state and its packed view for the march."""
        self.occ = occ
        self._occ_view = occupancy_view(occ.occ_grid, self.bound)

    # ------------------------------------------------------------- batch ----
    def device_batch(self, batch: dict, step: int) -> dict:
        """Numpy light batch → tensors on the device, with the rays,
        background coords, face mask and float pixels rebuilt."""
        dev = self.device
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                out[k] = torch.as_tensor(v, device=dev)
        out["idx"] = int(batch["idx"])
        out["step"] = float(step)
        ds = self.train_ds
        rays_o, rays_d, i, j = get_rays_device(
            out["pose_matrix"], ds.intrinsics, out["inds"], ds.H, ds.W
        )
        fr = out["face_rect"]
        out["rays_o"], out["rays_d"] = rays_o, rays_d
        out["bg_coords"] = bg_coords_device(out["inds"], ds.H, ds.W)
        out["face_mask"] = (j >= fr[0]) & (j < fr[1]) & (i >= fr[2]) & (i < fr[3])
        for k in ("gt_img", "bg_img", "bg_torso_img"):
            out[k] = out.pop(f"{k}_u8").float() / 255.0
        return out

    def render_kwargs(self) -> dict:
        cfg = self.cfg
        return dict(
            bound=self.bound,
            min_near=float(cfg.get("min_near", 0.05)),
            max_steps=int(cfg.get("max_steps", 16)),
            grid_size=self.grid_size,
            mean_samples_per_ray=float(self._spr_bucket or cfg.get("mean_samples_per_ray", 8)),
            lattice_K=int(self._latk_bucket or cfg.get("lattice_K", 32)),
        )

    # -------------------------------------------------------------- loss ----
    def loss_fn(self, batch: dict, noises: torch.Tensor | None, train: bool):
        """→ (total loss, dict of scalar tensors). ``batch`` from
        :meth:`device_batch`; ``noises [N]`` jitter the march."""
        cfg = self.cfg
        model = self.model
        cond_feat = model.cal_cond_feat(batch["cond_wins"])
        codes = model.individual_embeddings
        ind = codes[min(batch["idx"], codes.shape[0] - 1)] if codes is not None else None

        def field_fn(xyz, dirs):
            return model(xyz, dirs, cond_feat, ind)

        out = render_rays_radnerf(
            field_fn, batch["rays_o"], batch["rays_d"], self._occ_view,
            bg_color=batch["bg_torso_img"], noises=noises if train else None,
            **self.render_kwargs(),
        )
        pred, gt = out["rgb_map"], batch["gt_img"]
        mse = torch.mean((pred - gt) ** 2)
        losses = {
            "mse_loss": mse,
            "mean_samples": out["n_samples"].float().mean(),
            "march_span": out["march_span"].float(),
        }
        if train:
            a = out["weights_sum"].clamp(1e-5, 1 - 1e-5)
            losses["weights_entropy_loss"] = torch.mean(
                -a * torch.log2(a) - (1 - a) * torch.log2(1 - a)
            )
            losses["ambient_loss"] = torch.mean(out["ambient_sum"] * (~batch["face_mask"]))
            lambda_amb = min(batch["step"] / 250_000.0, 1.0) * cfg.get("lambda_ambient", 0.1)
            total = (
                mse
                + cfg.get("lambda_weights_entropy", 1e-4) * losses["weights_entropy_loss"]
                + lambda_amb * losses["ambient_loss"]
            )
        else:
            total = mse
        losses["total_loss"] = total
        losses["head_psnr"] = -10.0 * torch.log10(mse)
        return total, losses

    # ------------------------------------------------------------- steps ----
    def maybe_update_occ(self) -> bool:
        """The density sweep on every ``update_extra_interval``-th step, with
        the condition of a seeded random training frame."""
        cfg = self.cfg
        if self._step % int(cfg.get("update_extra_interval", 16)):
            return False
        idx = self._occ_rng.randint(len(self.train_ds))
        cond = get_cond_window(self.train_ds.conds, idx, cfg.get("smo_win_size", 5))
        model = self.model
        H = self.grid_size
        with torch.no_grad(), record_function("gf::occupancy"):
            cond_feat = model.cal_cond_feat(torch.as_tensor(cond, device=self.device))
            tables = model.grid_tables()
            noise = torch.rand(
                self.occ.density_grid.shape[0], H**3, 3, generator=self.generator,
                device=self.device,
            )
            self.set_occupancy(update_extra_state(
                lambda x: model.density(x, cond_feat, tables)["sigma"],
                self.occ, noise, grid_size=H, bound=self.bound,
                density_thresh=float(cfg.get("density_thresh", 10)),
            ))
        return True

    def maybe_retune_capacity(self, losses: dict) -> None:
        """Re-pick the lattice budget from the march span and the sample
        capacity from the mean samples per ray: on the first step and every
        ``capacity_check_interval`` steps (one host read each)."""
        cfg = self.cfg
        if self._checked and self._step % int(cfg.get("capacity_check_interval", 64)):
            return
        self._checked = True
        need = 1.15 * float(losses["march_span"])
        self._latk_bucket = min(
            [b for b in self.LATK_BUCKETS if b >= need] or [self.LATK_BUCKETS[-1]]
        )
        want = float(cfg.get("capacity_headroom", 1.15)) * float(losses["mean_samples"])
        spr = min([b for b in self.SPR_BUCKETS if b >= want] or [16.0])
        self._spr_bucket = min(spr, float(cfg.get("max_steps", 16)))

    def train_step(self, batch: dict) -> dict:
        """One update → the step's losses (0-d tensors on the device)."""
        swept = self.maybe_update_occ()
        with record_function("gf::batch"):
            dbatch = self.device_batch(batch, self._step)
            noises = torch.rand(
                dbatch["rays_o"].shape[0], generator=self.generator, device=self.device
            )
        self.optimizer.zero_grad(set_to_none=True)
        total, losses = self.loss_fn(dbatch, noises, train=True)
        with record_function("gf::backward"):
            total.backward()
        with record_function("gf::optim"):
            losses["grad_norm"] = torch.sqrt(sum(
                (p.grad.float() ** 2).sum() for p in self.model.parameters()
                if p.grad is not None
            ))
            self.optimizer.step()
        self.maybe_retune_capacity(losses)
        self._step += 1
        losses = {k: v.detach() for k, v in losses.items()}
        losses["occupancy_sweep"] = float(swept)
        return losses

    @torch.no_grad()
    def val_step(self, batch: dict) -> dict:
        return self.loss_fn(self.device_batch(batch, self._step), None, train=False)[1]

    # -------------------------------------------------------------- data ----
    def train_batches(self):
        return self.train_ds.iter_epochs()

    def val_batches(self):
        for i in range(len(self.val_ds)):
            yield self.val_ds[i]

    def checkpoint_payload(self, step: int) -> dict:
        """Params, occupancy and step in the JAX checkpoint layout, which
        both ``RADNeRFInfer``s read."""
        return {
            "state": {
                "params": state_dict_to_flax(self.model.state_dict()),
                "occ": tuple(self.occ),
            },
            "step": int(step),
            "extra": {"task_step": self._step},
        }
