"""Audio2Pose training task (port of ``geneface_tpu/tasks/audio2pose.py``):
the conditioned WaveNet trained teacher-forced on (audio window, pose and
velocity history ``pv[:, :-1]``) → the GMM parameters of ``pv[:, 1:]``
under ``gmm_log_loss`` (one center, 12 dimensions).

The store holds clips with ``audio [T, C]`` features and ``pose [T, 6]``
(euler, translation); the velocity is the first difference
(:func:`pose_to_pose_velocity`). Crops come from numpy ``RandomState``
draws, a copy of the JAX dataset's (``seed`` for train, ``seed + 1`` for
val), so the same seed gives the same batches bit for bit. The optimizer is
the JAX task's ``finalize_optimizer(optax.adam(build_schedule(cfg)))``:
optax's default betas (0.9, 0.999), eps 1e-8, ``guard_nan_grads``, and no
clipping although the shipped config sets ``clip_grad_norm`` (optax.adam
applies none). A validation is 4 batches.

The model's first layer takes ``audio_in_dim`` columns (58 by default; the
shipped ``egs/egs_bases/audio2pose/base.yaml`` sets 29): a store or a
condition of another width fails at the first forward, as in the JAX task.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from geneface_tpu_torch import resolve_device
from geneface_tpu_torch.convert import flax_variables, load_flax_variables
from geneface_tpu_torch.models.audio2pose import Audio2PoseModel, gmm_log_loss
from geneface_tpu_torch.models.layers import init_weights_
from geneface_tpu_torch.training.optim import build_adam
from geneface_tpu_torch.training.schedules import build_schedule
from geneface_tpu_torch.training.trainer import Task
from geneface_tpu_torch.utils.checkpoint import adam_state_from_optax
from geneface_tpu_torch.utils.indexed_dataset import IndexedDataset

__all__ = ["Audio2PoseTask", "pose_to_pose_velocity"]


def pose_to_pose_velocity(pose: np.ndarray) -> np.ndarray:
    """[T, 6] pose → [T, 12] (pose, velocity); velocity[0] = 0."""
    vel = np.zeros_like(pose)
    vel[1:] = pose[1:] - pose[:-1]
    return np.concatenate([pose, vel], -1)


class _PoseSeqDataset:
    def __init__(self, prefix, data_dir, seq_len=100, audio_dim=58, rng=None):
        self.ds = IndexedDataset(os.path.join(data_dir, prefix))
        self.seq_len = seq_len
        self.audio_dim = audio_dim
        self.rng = rng or np.random.RandomState(0)

    def __len__(self):
        return len(self.ds)

    def batch(self, batch_size):
        """Random fixed-length crops → audio [B, L, C], pv [B, L+1, 12]."""
        auds, pvs = [], []
        while len(auds) < batch_size:
            item = self.ds[self.rng.randint(len(self.ds))]
            audio = np.asarray(item["audio"], np.float32)
            pose = np.asarray(item["pose"], np.float32)
            T = min(len(audio), len(pose))
            if T < self.seq_len + 1:
                continue
            s = self.rng.randint(0, T - self.seq_len)
            auds.append(audio[s : s + self.seq_len])
            pvs.append(pose_to_pose_velocity(pose[s : s + self.seq_len + 1]))
        return {
            "audio": np.stack(auds),
            "pose_velocity": np.stack(pvs),  # [B, L+1, 12]
        }


class Audio2PoseTask(Task):
    def __init__(self, cfg, device=None):
        super().__init__(cfg)
        self.device = resolve_device(device)

    def build(self) -> None:
        cfg = self.cfg
        self.model = init_weights_(
            Audio2PoseModel(recept_field=cfg.get("recept_field", 100),
                            audio_in_dim=cfg.get("audio_in_dim", 58)),
            torch.Generator().manual_seed(int(cfg.get("seed", 9999))))
        self.model.to(self.device)
        data_dir = cfg.get("data_dir") or cfg.get("binary_data_dir", "data/binary/pose")
        L = cfg.get("seq_len", 100)
        seed = cfg.get("seed", 0)
        self.train_ds = _PoseSeqDataset("train", data_dir, L, cfg.get("audio_in_dim", 58),
                                        np.random.RandomState(seed))
        self.val_ds = _PoseSeqDataset("val", data_dir, L, cfg.get("audio_in_dim", 58),
                                      np.random.RandomState(seed + 1))
        self.batch_size = cfg.get("batch_size", 8)
        # optax.adam's own betas, not the config's
        self.optimizer = build_adam(self.model, build_schedule(cfg), dict(
            cfg, optimizer_adam_beta1=0.9, optimizer_adam_beta2=0.999))

    def to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v, dtype=torch.float32).to(self.device)
                for k, v in batch.items()}

    def loss_fn(self, dev: dict) -> tuple:
        pv = dev["pose_velocity"]
        # teacher forcing: history = pv[:-1], target = pv[1:] (the causal
        # WaveNet predicts the next step at each position)
        out = self.model(dev["audio"], pv[:, :-1])
        loss = gmm_log_loss(out, pv[:, 1:])
        return loss, {"gmm_loss": loss, "total_loss": loss}

    def train_step(self, batch: dict) -> dict:
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.loss_fn(self.to_device(batch))
        loss.backward()
        # every rank runs the whole batch (the JAX task names no
        # data_batch_keys): the average keeps the ranks identical
        self.sync_grads(self.model.parameters())
        self.optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def val_step(self, batch: dict) -> dict:
        return self.loss_fn(self.to_device(batch))[1]

    def train_batches(self, start_step: int = 0):
        while True:
            yield self.train_ds.batch(self.batch_size)

    def val_batches(self):
        for _ in range(4):
            yield self.val_ds.batch(self.batch_size)

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
        """DeepSpeech windows ``.npy`` → the predicted c2w ``.npy``
        (``Audio2PoseInfer``; reference ``inference/audio2pose/
        audio2pose_infer.example_run``)."""
        from geneface_tpu_torch.inference.audio2pose_infer import Audio2PoseInfer

        return Audio2PoseInfer(cfg, device=device).infer(
            deepspeech_npy=cfg.get("infer_audio_source_name"),
            out_npy=cfg.get("infer_out_npy_name") or "infer_out/pred_pose.npy",
            seed=cfg.get("seed", 0),
        )
