"""Audio2Motion VAE training with sync supervision (port of
``geneface_tpu/tasks/audio2motion.py``).

The HuBERT-conditioned landmark VAE trains on MSE + continuity (first-diff
MSE, ×3) + KL (× ``lambda_kl``) + a sync loss from a frozen SyncNet on the
predicted mouth landmarks (× ``lambda_sync`` once ``enable_sync`` is on: the
gate flips in a validation whose sync loss is ≤ 0.75, and the checkpoint
carries it). The SyncNet comes from ``syncnet_work_dir`` (either package's
run), or is the seeded init when that is empty. The sync clips are mined on
the host (positives only) and gathered from the predicted landmarks through
``gather_rows`` (K8; K1 carries their gradient back). The posterior noise
is drawn from a ``torch.Generator`` seeded from ``seed``.
``PitchContourVAESyncTask`` swaps in ``PitchContourVAEModel``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from geneface_tpu_torch import resolve_device
from geneface_tpu_torch.convert import flax_variables, load_flax_variables
from geneface_tpu_torch.models.audio2motion.flow import ResidualCouplingLayer
from geneface_tpu_torch.models.audio2motion.vae import PitchContourVAEModel, VAEModel
from geneface_tpu_torch.models.layers import init_weights_
from geneface_tpu_torch.models.syncnet.models import LandmarkHubertSyncNet, sync_loss
from geneface_tpu_torch.tasks.syncnet import (
    gather_clips,
    load_frozen,
    lrs3_datasets,
    mine_sync_clips,
    to_device,
)
from geneface_tpu_torch.training.optim import build_adam
from geneface_tpu_torch.training.schedules import build_schedule
from geneface_tpu_torch.training.trainer import Task
from geneface_tpu_torch.utils.checkpoint import adam_state_from_optax

__all__ = ["VAESyncAudio2MotionTask", "PitchContourVAESyncTask", "init_vae_", "mouth_of"]

BATCH_KEYS = ("hubert", "y", "y_mask", "f0")


def init_vae_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """The seeded random init, with the flow couplings' output convolutions
    at zero, as flax initializes them (the flow starts as the identity)."""
    init_weights_(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ResidualCouplingLayer):
                m.Conv_0.weight.zero_()
                m.Conv_0.bias.zero_()
    return model


def mouth_of(pred: torch.Tensor) -> torch.Tensor:
    """Landmarks ``[B, T, 204]`` → the 20 mouth points ``[B, T, 60]``."""
    B, T = pred.shape[:2]
    return pred.reshape(B, T, 68, 3)[:, :, 48:68].reshape(B, T, 60)


def sync_of(syncnet, pred, hubert, clip_idx) -> torch.Tensor:
    """The frozen SyncNet's loss on positive clips of the predicted mouth."""
    with record_function("gf::syncnet"):
        mouth_clips, mel_clips = gather_clips(mouth_of(pred), hubert, *clip_idx)
        a, m = syncnet(mel_clips, mouth_clips)
        return sync_loss(a, m, torch.ones(a.shape[0], device=a.device))[0]


class VAESyncAudio2MotionTask(Task):
    model_cls = VAEModel

    def __init__(self, cfg, device=None):
        super().__init__(cfg)
        self.device = resolve_device(device)

    def make_model(self) -> torch.nn.Module:
        return self.model_cls(in_out_dim=204, sqz_prior=self.cfg.get("sqz_prior", False),
                              use_prior_flow=self.cfg.get("use_prior_flow", True))

    def build(self) -> None:
        cfg = self.cfg
        seed = int(cfg.get("seed", 9999))
        self.model = init_vae_(self.make_model(), seed).to(self.device)
        data_dir = cfg.get("data_dir") or cfg.get("binary_data_dir", "data/binary/lrs3")
        self.train_ds, self.val_ds = lrs3_datasets(cfg, data_dir, 20000)
        self.np_rng = np.random.RandomState(seed)
        self.clip_batch = cfg.get("syncnet_num_samples_per_batch", 256)
        self.enable_sync = False
        self.syncnet = load_frozen(
            init_weights_(LandmarkHubertSyncNet(lm_dim=60, norm=cfg.get("syncnet_norm", "ln")),
                          torch.Generator().manual_seed(1)),
            cfg.get("syncnet_work_dir", ""), self.device)
        self.optimizer = build_adam(self.model, build_schedule(cfg), cfg)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)

    def prep(self, batch: dict) -> tuple:
        """A host batch → (its tensors on the device, the mined clips'
        indices ``(item, mouth_start, mel_item, mel_start)``)."""
        y_lens = batch["y_mask"].sum(-1).astype(int)
        ii, ms, mi, mel_s, _ = mine_sync_clips(y_lens, self.clip_batch, self.np_rng, infer=True)
        return to_device(batch, BATCH_KEYS, self.device), (ii, ms, mi, mel_s)

    def noise(self, dev: dict) -> torch.Tensor:
        """The posterior's standard-normal noise ``[B, T_sqz, 16]``."""
        B, T = dev["y_mask"].shape
        return torch.randn(self.model.noise_shape(B, T), generator=self.generator,
                           device=self.device)

    def loss_fn(self, dev: dict, clip_idx: tuple, noise: torch.Tensor,
                sync_weight: float) -> tuple:
        """→ (total, ``{mse, continuity, kl, sync, total_loss}``)."""
        with record_function("gf::vae"):
            out = self.model(dev, noise, train=True)
        pred = out["pred"]
        mask = dev["y_mask"][..., None]
        gt = dev["y"]
        denom = torch.clamp(mask.sum(), min=1.0) * 204
        mse = (((pred - gt) * mask) ** 2).sum() / denom
        diff_pred = (pred[:, 1:] - pred[:, :-1]) * mask[:, 1:]
        diff_gt = (gt[:, 1:] - gt[:, :-1]) * mask[:, 1:]
        continuity = ((diff_pred - diff_gt) ** 2).sum() / denom
        sync = sync_of(self.syncnet, pred, dev["hubert"], clip_idx)
        total = (mse + 3.0 * continuity + self.cfg.get("lambda_kl", 0.5) * out["loss_kl"]
                 + sync_weight * sync)
        return total, {"mse": mse, "continuity": continuity, "kl": out["loss_kl"],
                       "sync": sync, "total_loss": total}

    def sync_weight(self) -> float:
        return float(self.cfg.get("lambda_sync", 0.01)) if self.enable_sync else 0.0

    def train_step(self, batch: dict) -> dict:
        dev, clip_idx = self.prep(batch)
        self.optimizer.zero_grad(set_to_none=True)
        total, losses = self.loss_fn(dev, clip_idx, self.noise(dev), self.sync_weight())
        total.backward()
        # every rank runs the whole batch (the JAX task names no
        # data_batch_keys): the average keeps the ranks identical
        self.sync_grads(self.model.parameters())
        self.optimizer.step()
        return {k: v.detach() for k, v in losses.items()}

    @torch.no_grad()
    def val_step(self, batch: dict) -> dict:
        dev, clip_idx = self.prep(batch)
        losses = self.loss_fn(dev, clip_idx, self.noise(dev), 0.0)[1]
        if float(losses["sync"]) <= 0.75 and not self.enable_sync:  # the sync gate
            self.enable_sync = True
        return losses

    def train_batches(self, start_step: int = 0):
        return self.train_ds.iter_batches(seed=self.cfg.get("seed", 0))

    def val_batches(self):
        return self.val_ds.iter_batches(shuffle=False, infinite=False)

    def on_save(self) -> dict:
        return {"enable_sync": self.enable_sync}

    def on_restore(self, extra: dict) -> None:
        self.enable_sync = bool(extra.get("enable_sync", False))

    def checkpoint_payload(self, step: int) -> dict:
        return {"state": {"params": flax_variables(self.model),
                          "opt_state": self.optimizer.state_dict()},
                "step": int(step), "extra": self.on_save()}

    def restore_state(self, state: dict) -> None:
        """Parameters and Adam state of a port or JAX checkpoint."""
        load_flax_variables(self.model, state["params"])
        opt = state.get("opt_state")
        if opt is not None:
            self.optimizer.load_state_dict(
                opt if isinstance(opt, dict) else adam_state_from_optax(opt))

    @classmethod
    def run_inference(cls, cfg, device=None) -> np.ndarray:
        """wav → the VAE's raw motion ``.npy`` (``Audio2MotionInfer``)."""
        from geneface_tpu_torch.inference.audio2motion_infer import Audio2MotionInfer

        return Audio2MotionInfer(cfg, device=device).infer(
            wav_path=cfg.get("infer_audio_source_name"),
            out_npy=cfg.get("infer_out_npy_name") or "infer_out/pred_lm3d.npy",
            temperature=cfg.get("infer_temperature", 1.0),
            seed=cfg.get("seed", 0),
        )


class PitchContourVAESyncTask(VAESyncAudio2MotionTask):
    model_cls = PitchContourVAEModel
