"""SyncNet training task (port of ``geneface_tpu/tasks/syncnet.py``).

Clips are mined on the host in numpy (:func:`mine_sync_clips`, a copy of the
JAX function on the same ``RandomState`` draws, so the same seed gives the
same indices bit for bit): positives 50%; negatives from another clip of
the batch 25%, another offset in the clip 37.5%, a shift of ±[2, 5] frames
37.5%. :func:`gather_clips` gathers the 5-frame mouth and 10-frame HuBERT
clips on the device through the row gather ``ops/scatter.py::gather_rows``
(K8 forward, K1 backward) over the batch flattened to rows; the loss is
BCE on the cosine of the two towers' embeddings. With ``syncnet_norm: bn``
the BatchNorm's running statistics train with the weights, as in the JAX
task, whose Adam takes the whole variables tree (an oracle quirk).

Checkpoints hold ``state["params"]`` (flax variables) and ``opt_state``, as
the JAX task writes them, so either package's VAE and post-net tasks load
either package's SyncNet run.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from geneface_tpu_torch import resolve_device
from geneface_tpu_torch.convert import flax_variables, load_flax_variables
from geneface_tpu_torch.data.lrs3_dataset import LRS3SeqDataset
from geneface_tpu_torch.models.layers import init_weights_, train_running_stats_
from geneface_tpu_torch.models.syncnet.models import LandmarkHubertSyncNet, sync_loss
from geneface_tpu_torch.ops.scatter import gather_rows
from geneface_tpu_torch.training.optim import build_adam
from geneface_tpu_torch.training.schedules import build_schedule
from geneface_tpu_torch.training.trainer import Task
from geneface_tpu_torch.utils.checkpoint import (
    adam_state_from_optax,
    get_last_checkpoint,
    load_checkpoint,
)

__all__ = ["SyncNetTask", "mine_sync_clips", "gather_clips", "clip_rows", "lrs3_datasets",
           "load_frozen", "to_device"]


def mine_sync_clips(y_lens: np.ndarray, batch_size: int, rng: np.random.RandomState,
                    infer: bool = False):
    """→ (item_idx, mouth_start, mel_item, mel_start, labels), ``[K]`` each:
    the clip's item and first landmark frame, the audio's item and first
    landmark frame (its HuBERT rows start at twice that), and the label.
    ``infer``: positives only."""
    B = len(y_lens)
    item_idx, mouth_start, mel_start, labels = [], [], [], []
    while len(item_idx) < batch_size:
        for i in range(B):
            hi = int(y_lens[i]) - 6
            if hi < 1:
                continue
            exp_idx = rng.randint(0, hi + 1)
            pos = True if infer else bool(rng.randint(0, 2))
            if pos:
                src_i, mel_idx, label = i, exp_idx, 1.0
            else:
                r = rng.rand()
                if r < 0.25 and B > 1:
                    src_i = rng.randint(0, B)
                    hj = int(y_lens[src_i]) - 6
                    mel_idx = rng.randint(0, max(hj, 0) + 1)
                elif r < 0.625:
                    src_i = i
                    mel_idx = exp_idx
                    for _ in range(10):
                        mel_idx = rng.randint(0, hi + 1)
                        if mel_idx != exp_idx:
                            break
                else:
                    src_i = i
                    lo_off = max(-5, -exp_idx)
                    hi_off = min(5, hi - exp_idx)
                    off = 0
                    for _ in range(10):
                        off = rng.randint(lo_off, hi_off + 1)
                        if abs(off) > 1:
                            break
                    mel_idx = exp_idx + off
                label = 0.0
            item_idx.append(i)
            mouth_start.append(exp_idx)
            mel_start.append((src_i, mel_idx))
            labels.append(label)
            if len(item_idx) >= batch_size:
                break
    mel_item = np.array([m[0] for m in mel_start])
    mel_s = np.array([m[1] for m in mel_start])
    return (np.array(item_idx), np.array(mouth_start), mel_item, mel_s,
            np.array(labels, np.float32))


def clip_rows(item_idx, start, n_rows: int, width: int) -> np.ndarray:
    """Row indices ``item·n_rows + start + k`` (k < ``width``) of ``[K]``
    clips in a batch flattened to ``[B·n_rows]`` rows → int32 ``[K·width]``.
    A mined clip lies inside its item (the mouth clips end by frame
    ``T - 1``, the HuBERT clips by row ``2·(T - 6) + 9 < 2T``), so the row
    gather's zero fill never shows."""
    start = np.asarray(start, np.int64)
    if start.size and (start.min() < 0 or start.max() + width > n_rows):
        raise IndexError(f"a clip of {width} rows leaves its item of {n_rows}")
    rows = (np.asarray(item_idx, np.int64)[:, None] * n_rows + start[:, None]
            + np.arange(width)[None])
    return rows.reshape(-1).astype(np.int32)


def gather_clips(mouth: torch.Tensor, hubert: torch.Tensor, item_idx, mouth_start, mel_item,
                 mel_start):
    """Mouth clips ``[K, 5, C]`` of ``mouth [B, T, C]`` and HuBERT clips
    ``[K, 10, D]`` of ``hubert [B, 2T, D]`` (rows ``2·mel_start + k``),
    each one :func:`gather_rows` over the batch flattened to rows (K8; the
    gradient of ``mouth`` is K1's scatter-add of the clips' gradient)."""
    B, T, C = mouth.shape
    D = hubert.shape[-1]
    dev = mouth.device
    mrows = torch.from_numpy(clip_rows(item_idx, mouth_start, T, 5)).to(dev)
    hrows = torch.from_numpy(
        clip_rows(mel_item, 2 * np.asarray(mel_start), hubert.shape[1], 10)).to(dev)
    # a slice of contiguous landmarks reshapes to a strided view: the
    # gather reads a contiguous table
    mouth_clips = gather_rows(mouth.reshape(B * T, C).contiguous(), mrows, ("clip", "mouth"))
    mel_clips = gather_rows(hubert.reshape(-1, D).contiguous(), hrows, ("clip", "hubert"))
    return mouth_clips.reshape(-1, 5, C), mel_clips.reshape(-1, 10, D)


def lrs3_datasets(cfg, data_dir: str, default_max_tokens: int) -> tuple:
    """The train and val :class:`LRS3SeqDataset` of ``data_dir``."""
    max_tokens = cfg.get("max_tokens", default_max_tokens)
    return (LRS3SeqDataset("train", data_dir, max_tokens=max_tokens),
            LRS3SeqDataset("val", data_dir, max_tokens=max_tokens))


def to_device(batch: dict, keys, device) -> dict:
    """The numpy arrays of ``batch`` under ``keys`` as float32 tensors on
    ``device``."""
    return {k: torch.as_tensor(batch[k], dtype=torch.float32).to(device)
            for k in keys if k in batch}


def load_frozen(model: torch.nn.Module, work_dir: str, device) -> torch.nn.Module:
    """A frozen upstream: ``state["params"]`` of the newest checkpoint of
    ``work_dir`` (a work dir or a ``.ckpt`` path; either package's), or,
    with ``work_dir`` empty, the model as it was given (its seeded init) →
    in eval mode on ``device``, without gradients."""
    if work_dir:
        path = get_last_checkpoint(work_dir) or work_dir
        load_flax_variables(model, load_checkpoint(path)["state"]["params"])
    model.to(device).eval()
    for p in model.parameters():
        p.requires_grad_(False)
    return model


class SyncNetTask(Task):
    def __init__(self, cfg, device=None):
        super().__init__(cfg)
        self.device = resolve_device(device)

    def build(self) -> None:
        cfg = self.cfg
        seed = int(cfg.get("seed", 9999))
        norm = cfg.get("syncnet_norm", "ln")
        self.model = LandmarkHubertSyncNet(lm_dim=cfg.get("syncnet_lm_dim", 60), norm=norm)
        init_weights_(self.model, torch.Generator().manual_seed(seed))
        if norm == "bn":
            # the JAX task's Adam takes the whole variables tree: the frozen
            # BatchNorm statistics get gradients and move (an oracle quirk)
            train_running_stats_(self.model)
        self.model.to(self.device)
        data_dir = cfg.get("data_dir") or cfg.get("binary_data_dir", "data/binary/lrs3")
        self.train_ds, self.val_ds = lrs3_datasets(cfg, data_dir, 60000)
        self.clip_batch = cfg.get("syncnet_num_samples_per_batch", 1024)
        self.np_rng = np.random.RandomState(seed)
        self.optimizer = build_adam(self.model, build_schedule(cfg), cfg)

    def mine(self, batch: dict, infer: bool = False) -> dict:
        """Mine clips of a host batch and gather them on the device →
        ``{"mouth" [K, 5, 60], "mel" [K, 10, 1024], "labels" [K]}``."""
        y_lens = batch["y_mask"].sum(-1).astype(int)
        ii, ms, mi, mel_s, labels = mine_sync_clips(y_lens, self.clip_batch, self.np_rng,
                                                    infer=infer)
        dev = to_device(batch, ("mouth_lm3d", "hubert"), self.device)
        mouth, mel = gather_clips(dev["mouth_lm3d"], dev["hubert"], ii, ms, mi, mel_s)
        return {"mouth": mouth, "mel": mel, "labels": torch.from_numpy(labels).to(self.device)}

    def loss_fn(self, clips: dict) -> tuple:
        with record_function("gf::syncnet"):
            a, m = self.model(clips["mel"], clips["mouth"])
            loss, d = sync_loss(a, m, clips["labels"])
        return loss, {"sync_loss": loss, "cosine_sim": d.mean(), "total_loss": loss}

    def train_step(self, batch: dict) -> dict:
        clips = self.mine(batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.loss_fn(clips)
        loss.backward()
        # every rank runs the whole batch (the JAX task names no
        # data_batch_keys): the average keeps the ranks identical
        self.sync_grads(self.model.parameters())
        self.optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def val_step(self, batch: dict) -> dict:
        return self.loss_fn(self.mine(batch, infer=False))[1]

    def train_batches(self, start_step: int = 0):
        return self.train_ds.iter_batches(seed=self.cfg.get("seed", 0))

    def val_batches(self):
        return self.val_ds.iter_batches(shuffle=False, infinite=False)

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
