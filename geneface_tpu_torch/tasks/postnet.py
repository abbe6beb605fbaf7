"""The post-net adversarial domain adaptation task (port of
``geneface_tpu/tasks/postnet.py``): training, and the ``--infer`` entry.

The person-specific CNN post-net refines landmarks sampled from the frozen
LRS3 VAE (``audio2motion_work_dir``). Generator losses: person-domain MSE
(× ``postnet_lambda_mse``), ``reg`` — refined vs raw on the LRS3 batch
(× ``postnet_lambda_reg``), ``continuity`` — first differences and the
first frame vs the person's ground truth (× ``postnet_lambda_continuity``),
LSGAN ``adv`` against the frame-wise ``MLPDiscriminator`` (×
``postnet_lambda_adv``) and the frozen SyncNet's ``sync`` on the refined
LRS3 mouth (× ``postnet_lambda_sync``), the last two from step
``postnet_disc_start_steps``. The discriminator steps every
``postnet_disc_interval`` steps on the generator's detached LRS3
refinement against the person batch. Both optimizers are optax's RMSprop
on ``schedule(count)`` (× ``postnet_disc_lr_ratio`` for the
discriminator); the host-side step count is checkpointed.

As the JAX task does, it reads the person batches from ``person_data_dir``
(else the LRS3 store: the configs' ``person_binary_data_dir`` is unread) and
draws one person batch per training and per validation step. The pitch
variant is keyed off ``audio2motion_task_cls``: the frozen VAE is
``PitchContourVAEModel`` and the generator ``PitchContourCNNPostNet``,
conditioned on that VAE's own pitch embedding of the 2×-downsampled f0.

``--infer`` runs stage A: wav → HuBERT and f0 → VAE prior sample →
post-net → the lm3d ``.npy`` (``infer_out_npy_name``) that the RAD-NeRF
``--infer`` renders from; ``infer_hubert_npy`` (and ``infer_f0_npy`` for the
pitch variant) give pre-extracted features instead of the live HuBERT.

Over a mesh of ranks (the JAX task's ``data_batch_keys``) each rank keeps
its clips of the LRS3 and of the person batch when the clip count divides
by the data size (a batch that does not stays whole on every rank), with
its rows of the VAE's prior noise, drawn at the global batch. The masked
losses divide by the global mask sums (all-reduced) and count ``ranks ×``
this rank's numerator, so that the gradient average is the global batch's
gradient; the SyncNet term mines its clips from the whole refinement
(every rank mines the same clips from the same ``np_rng`` and gathers the
refined rows, :func:`~geneface_tpu_torch.parallel.all_gather_rows`). The
discriminator step follows the same rules. Every rank validates, so the
shared random streams (clip mining, the person batches, the noise) stay
the same on every rank.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from geneface_tpu_torch import parallel, resolve_device
from geneface_tpu_torch.convert import flax_variables, load_flax_variables
from geneface_tpu_torch.data.lrs3_dataset import LRS3SeqDataset
from geneface_tpu_torch.inference.audio2motion_infer import truncate16
from geneface_tpu_torch.inference.postnet_infer import PostnetInfer
from geneface_tpu_torch.models.audio2motion.vae import PitchContourVAEModel, VAEModel
from geneface_tpu_torch.models.layers import init_weights_
from geneface_tpu_torch.models.postnet.models import (
    CNNPostNet,
    MLPDiscriminator,
    PitchContourCNNPostNet,
)
from geneface_tpu_torch.models.syncnet.models import LandmarkHubertSyncNet
from geneface_tpu_torch.tasks.audio2motion import init_vae_, sync_of
from geneface_tpu_torch.tasks.syncnet import (
    load_frozen,
    lrs3_datasets,
    mine_sync_clips,
    to_device,
)
from geneface_tpu_torch.training.optim import RMSprop
from geneface_tpu_torch.training.schedules import build_schedule
from geneface_tpu_torch.training.trainer import Task
from geneface_tpu_torch.utils.checkpoint import rms_state_from_optax

__all__ = ["PostnetAdvSyncTask"]


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (x * mask).sum() / torch.clamp(mask.sum(), min=1.0)


class PostnetAdvSyncTask(Task):
    #: the clip axis, split over the mesh when it divides (the JAX task's)
    data_batch_keys = ("hubert", "y", "y_mask", "f0")

    def __init__(self, cfg, device=None):
        super().__init__(cfg)
        self.device = resolve_device(device)

    def build(self) -> None:
        cfg = self.cfg
        dev = self.device
        seed = int(cfg.get("seed", 9999))
        self.pitch = "pitch" in cfg.get("audio2motion_task_cls", "").lower()
        norm = cfg.get("postnet_norm", "ln")
        if self.pitch:
            self.model = PitchContourCNNPostNet(in_out_dim=204, pitch_dim=64, norm=norm)
        else:
            self.model = CNNPostNet(in_out_dim=204, norm=norm)
        init_weights_(self.model, torch.Generator().manual_seed(seed + 3)).to(dev)
        self.disc = init_weights_(MLPDiscriminator(in_dim=204),
                                  torch.Generator().manual_seed(seed + 4)).to(dev)
        lrs3_dir = cfg.get("lrs3_data_dir") or cfg.get("binary_data_dir", "data/binary/lrs3")
        self.train_ds, self.val_ds = lrs3_datasets(cfg, lrs3_dir, 20000)
        self.person_ds = LRS3SeqDataset("train", cfg.get("person_data_dir", lrs3_dir),
                                        max_tokens=cfg.get("max_tokens", 20000))
        self._person_iter = self.person_ds.iter_batches(seed=cfg.get("seed", 0) + 1)
        self.np_rng = np.random.RandomState(seed)
        self.clip_batch = cfg.get("syncnet_num_samples_per_batch", 256)
        vae_dir = cfg.get("audio2motion_work_dir", "")
        self.vae = load_frozen(init_vae_((PitchContourVAEModel if self.pitch else VAEModel)(
            in_out_dim=204), 0), vae_dir, dev)
        self.syncnet = load_frozen(
            init_weights_(LandmarkHubertSyncNet(lm_dim=60, norm=cfg.get("syncnet_norm", "ln")),
                          torch.Generator().manual_seed(2)),
            cfg.get("syncnet_work_dir", ""), dev)
        schedule = build_schedule(cfg)
        ratio = float(cfg.get("postnet_disc_lr_ratio", 1.0))
        kw = dict(guard_nan_grads=cfg.get("guard_nan_grads", True),
                  accumulate_grad_batches=int(cfg.get("accumulate_grad_batches", 1)))
        self.gen_opt = RMSprop(self.model, schedule, **kw)
        self.disc_opt = RMSprop(self.disc, lambda s: schedule(s) * ratio, **kw)
        self.generator = torch.Generator(device=dev).manual_seed(seed + 1)
        self._step = 0

    # ------------------------------------------------------------------
    def keys(self) -> tuple:
        return ("hubert", "y", "y_mask") + (("f0",) if self.pitch else ())

    def noise(self, dev: dict, rows: int | None = None) -> torch.Tensor:
        """The frozen VAE's prior noise ``[B, T_sqz, 16]`` for a batch (of
        ``rows`` clips: the global batch's)."""
        B, T = dev["y_mask"].shape
        return torch.randn(self.vae.noise_shape(rows or B, T), generator=self.generator,
                           device=self.device)

    @torch.no_grad()
    def vae_sample(self, dev: dict, noise: torch.Tensor) -> torch.Tensor:
        with record_function("gf::vae"):
            return self.vae(dev, noise)["pred"]

    def refine(self, raw: torch.Tensor, dev: dict) -> torch.Tensor:
        if self.pitch:
            with torch.no_grad():
                pitch = self.vae.pitch_features(dev["f0"])
            return self.model(raw, pitch)
        return self.model(raw)

    def prep(self, batch: dict, split: bool = True) -> tuple:
        """A host LRS3 batch → (its tensors on the device, the next person
        batch's, the mined clips' indices, mined from the whole batch, and
        the two batches' global clip counts); over a mesh and with
        ``split``, this rank's clips of each batch."""
        keys = self.keys()
        person = next(self._person_iter)
        y_lens = batch["y_mask"].sum(-1).astype(int)
        ii, ms, mi, mel_s, _ = mine_sync_clips(y_lens, self.clip_batch, self.np_rng, infer=True)
        rows = (len(batch["y"]), len(person["y"]))
        if split:
            batch, person = self.place_batch(batch), self.place_batch(person)
        return (to_device(batch, keys, self.device), to_device(person, keys, self.device),
                (ii, ms, mi, mel_s), rows)

    def _split(self, global_rows: int, local_rows: int) -> tuple:
        """(the factor of this rank's numerators, the all-reduce of a
        denominator) of a batch with ``global_rows`` clips of which this
        rank holds ``local_rows``."""
        if self.mesh is None or global_rows == local_rows:
            return 1, lambda x: x
        group = self.data_group()

        def total(x):
            x = x.clone()
            torch.distributed.all_reduce(x, group=group)
            return x

        return parallel.data_size(self.mesh), total

    def gen_loss(self, lrs3: dict, person: dict, clip_idx: tuple, noises: tuple,
                 adv_on: float, rows: tuple | None = None) -> tuple:
        """→ (total, losses, the detached LRS3 refinement); ``noises`` the
        VAE's prior noise of the LRS3 and of the person batch; ``rows``
        the two batches' global clip counts (split over ranks)."""
        cfg = self.cfg
        k_p, total_p = self._split(rows[1], len(person["y"])) if rows else (1, lambda x: x)
        k_l, total_l = self._split(rows[0], len(lrs3["y"])) if rows else (1, lambda x: x)
        raw_lrs3 = self.vae_sample(lrs3, noises[0])
        raw_person = self.vae_sample(person, noises[1])
        with record_function("gf::postnet_gen"):
            pmask = person["y_mask"]
            refine_person = self.refine(raw_person, person) * pmask[..., None]
            denom = torch.clamp(total_p(pmask.sum()), min=1.0) * 204 / k_p
            mse = ((person["y"] - refine_person) ** 2).sum() / denom
            d_pred = refine_person[:, 1:] - refine_person[:, :-1]
            d_gt = person["y"][:, 1:] - person["y"][:, :-1]
            cont_err = (d_pred - d_gt) * pmask[:, 1:, None]
            init_err = refine_person[:, 0, :] - person["y"][:, 0, :]
            continuity = ((cont_err**2).sum() + (init_err**2).sum()) / denom
            refine_lrs3 = self.refine(raw_lrs3, lrs3)
            reg = (((refine_lrs3 - raw_lrs3) * lrs3["y_mask"][..., None]) ** 2).sum() / (
                torch.clamp(total_l(lrs3["y_mask"].sum()), min=1.0) / k_l)
            whole = (lambda x: parallel.all_gather_rows(self.mesh, x)) if k_l > 1 else (lambda x: x)
            sync = sync_of(self.syncnet, whole(refine_lrs3), whole(lrs3["hubert"]), clip_idx)
            v, fmask = self.disc(refine_lrs3)
            fmask = fmask.float()
            adv = ((1.0 - v[..., 0]) ** 2 * fmask).sum() / (
                torch.clamp(total_l(fmask.sum()), min=1.0) / k_l)
            total = (cfg.get("postnet_lambda_mse", 0.05) * mse
                     + cfg.get("postnet_lambda_reg", 0.0) * reg
                     + cfg.get("postnet_lambda_continuity", 0.0) * continuity
                     + adv_on * cfg.get("postnet_lambda_adv", 0.85) * adv
                     + adv_on * cfg.get("postnet_lambda_sync", 0.1) * sync)
        losses = {"mse": mse, "adv": adv, "sync": sync, "reg": reg, "continuity": continuity,
                  "total_loss": total}
        return total, losses, refine_lrs3.detach()

    def disc_loss(self, fake: torch.Tensor, real: torch.Tensor, real_mask: torch.Tensor,
                  rows: tuple | None = None) -> tuple:
        """LSGAN: the refinement to 0, the person's landmarks to 1;
        ``rows`` the two batches' global clip counts (split over ranks)."""
        k_f, total_f = self._split(rows[0], len(fake)) if rows else (1, lambda x: x)
        k_r, total_r = self._split(rows[1], len(real)) if rows else (1, lambda x: x)

        def mean_f(x, m):
            return (x * m).sum() / (torch.clamp(total_f(m.sum()), min=1.0) / k_f)

        def mean_r(x, m):
            return (x * m).sum() / (torch.clamp(total_r(m.sum()), min=1.0) / k_r)

        with record_function("gf::postnet_disc"):
            v_fake, m_fake = self.disc(fake)
            v_real, m_real = self.disc(real)
            m_fake = m_fake.float()
            m_real = m_real.float() * real_mask
            fake_loss = mean_f(v_fake[..., 0] ** 2, m_fake)
            true_loss = mean_r((v_real[..., 0] - 1.0) ** 2, m_real)
        return fake_loss + true_loss, {
            "disc_fake_loss": fake_loss, "disc_true_loss": true_loss,
            "disc_neg_conf": mean_f(v_fake[..., 0].detach(), m_fake),
            "disc_pos_conf": mean_r(v_real[..., 0].detach(), m_real),
        }

    def adv_on(self) -> float:
        return 1.0 if self._step >= self.cfg.get("postnet_disc_start_steps", 0) else 0.0

    def disc_due(self) -> bool:
        return self._step % self.cfg.get("postnet_disc_interval", 1) == 0

    def train_step(self, batch: dict) -> dict:
        lrs3, person, clip_idx, rows = self.prep(batch)
        # the prior noise at the global batches' shapes, then this rank's rows
        noises = tuple(self.local_rows(self.noise(d, r)) for d, r in zip((lrs3, person), rows))
        self.gen_opt.zero_grad(set_to_none=True)
        total, losses, pred = self.gen_loss(lrs3, person, clip_idx, noises, self.adv_on(), rows)
        total.backward()
        self.sync_grads(self.model.parameters())
        self.gen_opt.step()
        if self.disc_due():
            self.disc_opt.zero_grad(set_to_none=True)
            d_total, d_losses = self.disc_loss(pred, person["y"], person["y_mask"], rows)
            d_total.backward()
            self.sync_grads(self.disc.parameters())
            self.disc_opt.step()
            losses.update(d_losses)
        self._step += 1
        return self.reduce_metrics({k: v.detach() for k, v in losses.items()})

    @torch.no_grad()
    def val_step(self, batch: dict) -> dict:
        """The person batch's MSE (the LRS3 batch only draws its clips, as
        the JAX task does)."""
        _, person, _, _ = self.prep(batch, split=False)
        refined = self.refine(self.vae_sample(person, self.noise(person)), person)
        denom = torch.clamp(person["y_mask"].sum(), min=1.0) * 204
        mse = ((person["y"] - refined * person["y_mask"][..., None]) ** 2).sum() / denom
        return {"total_loss": mse, "mse": mse}

    def train_batches(self, start_step: int = 0):
        self._step = start_step
        return self.train_ds.iter_batches(seed=self.cfg.get("seed", 0))

    def val_batches(self):
        return self.val_ds.iter_batches(shuffle=False, infinite=False)

    def on_save(self) -> dict:
        return {"task_step": self._step}

    def on_restore(self, extra: dict) -> None:
        self._step = int(extra.get("task_step", self._step))

    def checkpoint_payload(self, step: int) -> dict:
        return {"state": {"gen_params": flax_variables(self.model),
                          "disc_params": flax_variables(self.disc),
                          "gen_opt": self.gen_opt.state_dict(),
                          "disc_opt": self.disc_opt.state_dict()},
                "step": int(step), "extra": self.on_save()}

    def restore_state(self, state: dict) -> None:
        """Both networks and both RMSprop states of a port or JAX run."""
        load_flax_variables(self.model, state["gen_params"])
        load_flax_variables(self.disc, state["disc_params"])
        for opt, key in ((self.gen_opt, "gen_opt"), (self.disc_opt, "disc_opt")):
            s = state.get(key)
            if s is not None:
                opt.load_state_dict(s if isinstance(s, dict) else rms_state_from_optax(s))

    @classmethod
    def run_inference(cls, cfg, device=None) -> np.ndarray:
        """→ the predicted lm3d ``[T, 68, 3]``, also saved as ``[1, T, 68, 3]``."""
        infer = PostnetInfer(cfg, device=device)
        hubert = f0 = None
        if cfg.get("infer_hubert_npy", ""):
            hubert = np.load(cfg["infer_hubert_npy"])
            hubert = hubert[: truncate16(len(hubert))]
            if cfg.get("infer_f0_npy", ""):
                f0 = np.load(cfg["infer_f0_npy"])[: len(hubert)]
        return infer.infer(
            wav_path=cfg.get("infer_audio_source_name"),
            hubert=hubert,
            f0=f0,
            out_npy=cfg.get("infer_out_npy_name") or "infer_out/pred_lm3d.npy",
            temperature=cfg.get("infer_temperature", 1.0),
            seed=cfg.get("seed", 0),
        )
