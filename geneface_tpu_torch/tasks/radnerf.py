"""RAD-NeRF head training task (port of ``geneface_tpu/tasks/radnerf.py``).

One step: the occupancy sweep on interval steps, the jittered compact
render of a random ray batch, the losses (MSE + weights entropy + the
ambient loss ramped over 250k steps), ``backward`` and the multi-group Adam
update. Like the JAX task it re-picks the sample capacity and the lattice
budget from the measured mean samples per ray and march span (one host
read on the first step and every ``capacity_check_interval`` steps), from
the same buckets, so the same samples are dropped.

The lip fine-tune phase (``finetune_lips``) is the JAX task's: from step
``finetune_lips_start_iter`` the task flips its (and the dataset's)
``finetune_lip_flag`` after every step, the dataset then serves every other
item as a P×P lip patch (``lip_patch_size``), and a batch marked
``is_lip_patch`` trains with the LPIPS term ``lambda_lpips_loss ·
mean(LPIPS(pred, gt))`` on the patch, rendered at the config's
``mean_samples_per_ray`` and ``lattice_K`` (the JAX lip step is built once,
without the retuned buckets); the occupancy sweep is frozen once the phase
starts. LPIPS reads ``lpips_weights`` (a converted ``.npz``); without it
the build raises unless ``allow_random_lpips`` is set.

The task owns its state: the model, the optimizer and the occupancy grids;
its checkpoints hold all three (``opt_state`` in the flax layout) and
``task_step``, and :meth:`restore_state` reads the port's and the JAX
trainer's. After each logged validation it renders one full val frame
(``val_render_frame``) and logs ``val/full_frame_psnr`` and the image.
Supported: every ``grid_backend`` (``fused``, ``reference``, ``block``);
``march_backend: lattice`` (the lattice march and the compaction) and
``walk`` (the walk, then the compaction or, with ``mean_samples_per_ray:
0``, the padded slab — the GeneFace import config's route). Noise comes
from the task's seeded ``torch.Generator`` on the device and reaches the
renderer and the sweep as tensors.

Over a mesh of ranks (:meth:`Task.setup_mesh`) a step is the global
batch's step, as under the JAX task's sharded ``train_step``: each rank
renders its rows of ``data_batch_keys`` with its rows of the march jitter,
which is drawn at the global ray count from the shared generator; the
sample budget is waterfilled over all ranks; the lip step's LPIPS sees the
whole patch (:func:`~geneface_tpu_torch.parallel.all_gather_rows`); the
gradients are averaged over the ranks before Adam and the metrics reduced
(``march_span`` by its maximum), so every rank retunes the same buckets.
Every rank runs the occupancy sweep with the same noise, then takes rank
0's grids.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from torch.profiler import record_function

from geneface_tpu_torch import parallel, resolve_device
from geneface_tpu_torch.convert import flax_to_state_dict, lpips_state_dict, state_dict_to_flax
from geneface_tpu_torch.data.radnerf_dataset import RADNeRFDataset, get_cond_window
from geneface_tpu_torch.models.lpips import LPIPS, lpips_params_from_npz
from geneface_tpu_torch.models.radnerf import (
    OccupancyState,
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
from geneface_tpu_torch.utils.camera import bg_coords_device, get_rays, get_rays_device
from geneface_tpu_torch.utils.checkpoint import adam_state_from_optax

__all__ = ["RADNeRFTask"]


class RADNeRFTask(Task):
    """``device`` defaults to ``cuda``; ``dtype`` is the field MLPs' compute
    dtype (bf16, as the JAX model's default); the grids compute in f32."""

    #: sample-capacity buckets (mean samples per ray) and lattice budgets
    #: of the JAX task
    SPR_BUCKETS = (2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 10.0, 12.0, 16.0)
    LATK_BUCKETS = (16, 24, 32, 48, 64, 96, 128)

    #: the light batch's per-ray leaves (the JAX task's list; the port's
    #: batch carries the indices and the uint8 pixels)
    data_batch_keys = (
        "rays_o", "rays_d", "gt_img", "bg_img", "bg_torso_img",
        "bg_coords", "face_mask",
        "inds", "gt_img_u8", "bg_img_u8", "bg_torso_img_u8",
    )

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
        if self.march_backend() not in ("lattice", "walk"):
            raise ValueError(f"march_backend {self.march_backend()!r}: 'lattice' or 'walk'")
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
        self._frame_kwargs = None  # the val frame's render kwargs, fixed at its first call
        self.finetune_lip_flag = False
        self.build_lpips()

    def build_lpips(self) -> None:
        """The frozen LPIPS of the lip phase (``None`` without
        ``finetune_lips``): ``lpips_weights``, else, only with
        ``allow_random_lpips``, a random init seeded from ``seed``."""
        cfg = self.cfg
        self.lpips = None
        if not cfg.get("finetune_lips", True):
            return
        lpips = LPIPS()
        weights = cfg.get("lpips_weights", "")
        if weights:
            lpips.load_state_dict({k: torch.as_tensor(v) for k, v in
                                   lpips_state_dict(lpips_params_from_npz(weights)).items()})
        else:
            # the reference trains the lip phase against released LPIPS
            # weights; the JAX package measured a random-init one to hurt
            # the lip region, so an unconfigured run fails fast
            if not cfg.get("allow_random_lpips", False):
                raise ValueError(
                    "finetune_lips is enabled but no LPIPS weights are "
                    "configured (cfg key 'lpips_weights') — a random-init "
                    "perceptual net measurably degrades the lip region "
                    "(docs/perf_notes.md). Convert the released torch "
                    "weights with tools/convert_lpips_torch.py and set "
                    "lpips_weights, disable finetune_lips, or set "
                    "allow_random_lpips: true to override."
                )
            logging.getLogger("geneface_tpu_torch").warning(
                "LPIPS weights not configured (cfg key 'lpips_weights'); the "
                "lip-finetune perceptual loss will use a RANDOM-INIT network "
                "(allow_random_lpips override active)."
            )
            lpips.reset_parameters(torch.Generator().manual_seed(int(cfg.get("seed", 9999)) + 3))
        self.lpips = lpips.to(self.device)

    def in_lip_phase(self) -> bool:
        """``finetune_lips`` and the task step past ``finetune_lips_start_iter``."""
        cfg = self.cfg
        return bool(cfg.get("finetune_lips", True)) and self._step > int(
            cfg.get("finetune_lips_start_iter", 200_000))

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

    def state_tensors(self) -> list:
        return super().state_tensors() + list(self.occ)

    def place_state(self) -> None:
        super().place_state()
        self.set_occupancy(self.occ)

    def take_rank0_occupancy(self) -> None:
        """Every rank swept with the same noise; rank 0's grids, density
        EMA and mean density win, so the ranks cannot drift apart."""
        if self.mesh is not None:
            parallel.broadcast_tensors(self.mesh, list(self.occ))
            self.set_occupancy(self.occ)

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

    def march_backend(self) -> str:
        return str(self.cfg.get("march_backend", "lattice"))

    def render_kwargs(self, lip: bool = False) -> dict:
        """The training render's kwargs: the retuned capacities, or for a
        lip step the config's. ``march_backend: walk`` marches with the walk
        (then compacts when ``mean_samples_per_ray > 0``, else renders the
        padded slab), as the JAX task does."""
        cfg = self.cfg
        spr, latk = (None, None) if lip else (self._spr_bucket, self._latk_bucket)
        if latk is None and self.march_backend() == "lattice":
            latk = int(cfg.get("lattice_K", 32))
        return dict(
            bound=self.bound,
            min_near=float(cfg.get("min_near", 0.05)),
            dt_gamma=float(cfg.get("dt_gamma", 1.0 / 256)),
            max_steps=int(cfg.get("max_steps", 16)),
            grid_size=self.grid_size,
            mean_samples_per_ray=float(spr or cfg.get("mean_samples_per_ray", 8)),
            lattice_K=latk,
        )

    # -------------------------------------------------------------- loss ----
    def loss_fn(self, batch: dict, noises: torch.Tensor | None, train: bool,
                lip: bool = False):
        """→ (total loss, dict of scalar tensors). ``batch`` from
        :meth:`device_batch`; ``noises [N]`` jitter the march; ``lip``: the
        batch is a lip patch, trained with the LPIPS term."""
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
            group=self.data_group() if train else None, **self.render_kwargs(lip),
        )
        pred, gt = out["rgb_map"], batch["gt_img"]
        mse = torch.mean((pred - gt) ** 2)
        losses = {"mse_loss": mse, "mean_samples": out["n_samples"].float().mean()}
        if out["march_span"] is not None:  # the lattice march's
            losses["march_span"] = out["march_span"].float()
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
            if lip and self.lpips is not None:
                # the lip patch's rays are its P×P pixels in row-major order
                # (split over ranks: every rank scores the whole patch)
                P = int(cfg.get("lip_patch_size", 64))
                with record_function("gf::lpips"):
                    pred_p = parallel.all_gather_rows(self.mesh, pred)
                    gt_p = parallel.all_gather_rows(self.mesh, gt)
                    lp = torch.mean(self.lpips(pred_p.reshape(1, P, P, 3),
                                               gt_p.reshape(1, P, P, 3)))
                losses["lpips_loss"] = lp
                total = total + cfg.get("lambda_lpips_loss", 0.001) * lp
        else:
            total = mse
        losses["total_loss"] = total
        losses["head_psnr"] = -10.0 * torch.log10(mse)
        return total, losses

    # ------------------------------------------------------------- steps ----
    def maybe_update_occ(self) -> bool:
        """The density sweep on every ``update_extra_interval``-th step, with
        the condition of a seeded random training frame; frozen once the lip
        phase has started (the reference's step threshold)."""
        cfg = self.cfg
        if self._step % int(cfg.get("update_extra_interval", 16)) or self.in_lip_phase():
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
            self.take_rank0_occupancy()
        return True

    def maybe_retune_capacity(self, losses: dict) -> None:
        """Re-pick the lattice budget from the march span (the lattice
        march's) and the sample capacity from the mean samples per ray (not
        on the padded slab, ``mean_samples_per_ray: 0``): on the first step
        and every ``capacity_check_interval`` steps (one host read each)."""
        cfg = self.cfg
        if self._checked and self._step % int(cfg.get("capacity_check_interval", 64)):
            return
        self._checked = True
        if "march_span" in losses:
            need = 1.15 * float(losses["march_span"])
            self._latk_bucket = min(
                [b for b in self.LATK_BUCKETS if b >= need] or [self.LATK_BUCKETS[-1]]
            )
        if not cfg.get("mean_samples_per_ray", 8):  # the padded slab: no capacity
            return
        want = float(cfg.get("capacity_headroom", 1.15)) * float(losses["mean_samples"])
        spr = min([b for b in self.SPR_BUCKETS if b >= want] or [16.0])
        self._spr_bucket = min(spr, float(cfg.get("max_steps", 16)))

    def train_step(self, batch: dict) -> dict:
        """One update → the step's losses (0-d tensors on the device). A
        batch marked ``is_lip_patch`` is a lip step: the batch decides, since
        the prefetching iterator delivers a flag change one item late."""
        swept = self.maybe_update_occ()
        lip = bool(self.lpips is not None and batch.get("is_lip_patch"))
        with record_function("gf::batch"):
            local, n_rays = self.split_batch(batch, "inds")
            dbatch = self.device_batch(local, self._step)
            # drawn at the global ray count, then this rank's rows
            noises = self.local_rows(
                torch.rand(n_rays, generator=self.generator, device=self.device))
        self.optimizer.zero_grad(set_to_none=True)
        total, losses = self.loss_fn(dbatch, noises, train=True, lip=lip)
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
            losses = self.reduce_metrics(losses, max_keys=("march_span",))
            losses["head_psnr"] = -10.0 * torch.log10(losses["mse_loss"])
        self.maybe_retune_capacity(losses)
        self._step += 1
        if self.in_lip_phase():  # the lip and normal steps alternate
            self.finetune_lip_flag = not self.finetune_lip_flag
            self.train_ds.finetune_lip_flag = self.finetune_lip_flag
        losses = {k: v.detach() for k, v in losses.items()}
        losses["occupancy_sweep"] = float(swept)
        return losses

    @torch.no_grad()
    def val_step(self, batch: dict) -> dict:
        return self.loss_fn(self.device_batch(batch, self._step), None, train=False)[1]

    # ------------------------------------------------------- val frame ----
    def frame_kwargs(self) -> dict:
        """The val frame's render kwargs: the config's sample capacity, and
        (``march_backend: lattice``) the lattice budget retuned so far, both
        fixed at the first call (the JAX task compiles its frame function
        once)."""
        if self._frame_kwargs is None:
            cfg = self.cfg
            lattice = self.march_backend() == "lattice"
            self._frame_kwargs = dict(
                bound=self.bound,
                min_near=float(cfg.get("min_near", 0.05)),
                max_steps=int(cfg.get("max_steps", 16)),
                grid_size=self.grid_size,
                dt_gamma=float(cfg.get("dt_gamma", 1.0 / 256)),
                mean_samples_per_ray=float(cfg.get("mean_samples_per_ray", 8)),
                lattice_K=int(self._latk_bucket or cfg.get("lattice_K", 32)) if lattice else None,
            )
        return self._frame_kwargs

    def frame_inputs(self, ds, idx: int) -> tuple:
        """(rays_o, rays_d, condition window, ground truth [H, W, 3]) of
        frame ``idx`` of ``ds`` over all its pixels, on the device."""
        dev = self.device
        rays = get_rays(ds.poses[idx], ds.intrinsics, ds.H, ds.W)
        cond = get_cond_window(ds.conds, idx, self.cfg.get("smo_win_size", 5))
        return (torch.as_tensor(rays["rays_o"], device=dev),
                torch.as_tensor(rays["rays_d"], device=dev),
                torch.as_tensor(cond, device=dev), ds._gt(ds.samples[idx]))

    @torch.no_grad()
    def render_full_frame(self, ds=None, idx: int = 0) -> tuple:
        """All H·W rays of frame ``idx`` (the val split's by default),
        unjittered and without the cull → (image [H, W, 3], ground truth
        [H, W, 3]), float numpy."""
        ds = ds or self.val_ds
        model = self.model
        rays_o, rays_d, cond, gt = self.frame_inputs(ds, idx)
        cond_feat = model.cal_cond_feat(cond)
        codes = model.individual_embeddings
        ind = codes[0] if codes is not None else None
        bg = torch.as_tensor(ds._bg_torso(ds.samples[idx]).reshape(-1, 3), device=self.device)
        out = render_rays_radnerf(
            lambda xyz, dirs: model(xyz, dirs, cond_feat, ind), rays_o, rays_d,
            self._occ_view, bg_color=bg, **self.frame_kwargs(),
        )
        return out["rgb_map"].float().cpu().numpy().reshape(ds.H, ds.W, 3), gt

    def on_validation_end(self, step: int, logger) -> None:
        """Log the full val frame (``val/render``) and its PSNR
        (``val/full_frame_psnr``) unless ``val_render_frame`` is off."""
        if not self.cfg.get("val_render_frame", True):
            return
        img, gt = self.render_full_frame()
        mse = float(np.mean((img - gt) ** 2))
        logger.log_image("val/render", img, step)
        logger.log_scalars({"full_frame_psnr": -10.0 * np.log10(max(mse, 1e-12))}, step,
                           prefix="val/")

    # -------------------------------------------------------------- data ----
    def train_batches(self, start_step: int = 0):
        self._step = start_step
        return self.train_ds.iter_epochs()

    def val_batches(self):
        for i in range(len(self.val_ds)):
            yield self.val_ds[i]

    # ------------------------------------------------------ checkpoints ----
    def on_save(self) -> dict:
        return {"task_step": self._step}

    def on_restore(self, extra: dict) -> None:
        self._step = int(extra.get("task_step", self._step))

    def checkpoint_payload(self, step: int) -> dict:
        """Params, occupancy and the optimizer state in the JAX checkpoint
        layout (both ``RADNeRFInfer``s read it), the step and ``task_step``."""
        return {
            "state": {
                "params": state_dict_to_flax(self.model.state_dict()),
                "occ": tuple(self.occ),
                "opt_state": self.optimizer.state_dict(),
            },
            "step": int(step),
            "extra": self.on_save(),
        }

    def restore_state(self, state: dict) -> None:
        """Parameters, occupancy and optimizer state of a checkpoint
        written by the port or by the JAX trainer (optax's state tree). A
        checkpoint without optimizer state (an imported GeneFace one,
        ``utils/torch_import.py``) keeps the fresh optimizer: a fine-tune."""
        dev = self.device
        self.model.load_state_dict(
            {k: torch.as_tensor(v) for k, v in flax_to_state_dict(state["params"]).items()})
        self.set_occupancy(OccupancyState(
            *[torch.as_tensor(np.asarray(x), device=dev) for x in state["occ"]]))
        opt = state.get("opt_state")
        if opt is None:
            return
        self.optimizer.load_state_dict(
            opt if isinstance(opt, dict) else adam_state_from_optax(opt))
