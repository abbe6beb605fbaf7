"""Task protocol and the training loop (port of
``geneface_tpu/training/trainer.py``, one device, no mesh).

A :class:`Task` owns its model, optimizer and auxiliary state;
:meth:`Trainer.fit` runs the sanity validation, the steps, the periodic
validation and the checkpoints (``model_ckpt_steps_<n>.ckpt`` in the JAX
layout, the newest ``num_ckpt_keep`` kept) and logs to
``<work_dir>/metrics.jsonl``. Step metrics stay on the device until a log
step reads them. Resuming (with the Adam moments) is not ported: a work dir
that already holds checkpoints is refused rather than overwritten.
"""

from __future__ import annotations

import os
import time
from typing import Iterator

from geneface_tpu_torch.config.config import save_config
from geneface_tpu_torch.utils.checkpoint import get_all_checkpoints, save_step_checkpoint
from geneface_tpu_torch.utils.logging import MetricsLogger
from geneface_tpu_torch.utils.meters import MeterBank

__all__ = ["Task", "Trainer"]


class Task:
    """Subclass and implement ``build``, ``train_step``, ``val_step``,
    ``train_batches``, ``val_batches`` and ``checkpoint_payload``."""

    def __init__(self, cfg):
        self.cfg = cfg

    def build(self) -> None:
        """Create the model, optimizer, datasets and state."""
        raise NotImplementedError

    def train_step(self, batch) -> dict:
        """One update → metrics (scalars or 0-d tensors)."""
        raise NotImplementedError

    def val_step(self, batch) -> dict:
        """→ metrics; includes ``total_loss``."""
        raise NotImplementedError

    def train_batches(self) -> Iterator:
        raise NotImplementedError

    def val_batches(self) -> Iterator:
        raise NotImplementedError

    def checkpoint_payload(self, step: int) -> dict:
        raise NotImplementedError

    @classmethod
    def run_inference(cls, cfg, device=None):
        """The ``--infer`` entry of the task family (overridden per task)."""
        raise NotImplementedError(f"{cls.__name__} has no inference pipeline")


class Trainer:
    def __init__(self, task: Task):
        self.task = task
        self.cfg = task.cfg
        self.work_dir = self.cfg.get("work_dir") or os.path.join(
            "checkpoints", self.cfg.get("exp_name", "default")
        )
        if self.cfg.get("resume_from_checkpoint", 0) or get_all_checkpoints(self.work_dir):
            raise NotImplementedError(
                f"{self.work_dir} holds checkpoints: resuming is not ported yet; "
                "train into a fresh work dir"
            )
        os.makedirs(self.work_dir, exist_ok=True)
        save_config(self.cfg, self.work_dir)
        self.logger = MetricsLogger(self.work_dir)

    def fit(self) -> int:
        """Train to ``max_updates``; returns the last step."""
        cfg = self.cfg
        task = self.task
        task.build()
        n_sanity = int(cfg.get("num_sanity_val_steps", 2))
        if n_sanity:
            self.validate(step=0, max_batches=n_sanity, log=False)
        max_updates = int(cfg.get("max_updates", 10000))
        val_interval = int(cfg.get("val_check_interval", 2000))
        log_interval = int(cfg.get("tb_log_interval", 100))
        pending = []
        t_last = time.time()
        train_iter = task.train_batches()
        step = 0
        while step < max_updates:
            pending.append(task.train_step(next(train_iter)))
            step += 1
            if step % log_interval == 0:
                meters = MeterBank()
                for m in pending:
                    meters.update(m)
                pending.clear()
                avgs = meters.averages()
                now = time.time()
                avgs["steps_per_sec"] = log_interval / max(now - t_last, 1e-9)
                t_last = now
                self.logger.log_scalars(avgs, step, prefix="tr/")
                print(f"| step {step}: " + ", ".join(
                    f"{k}={v:.4g}" for k, v in sorted(avgs.items())), flush=True)
            if step % val_interval == 0 or step == max_updates:
                self.validate(step=step)
                save_step_checkpoint(
                    self.work_dir, step, task.checkpoint_payload(step),
                    num_keep=int(cfg.get("num_ckpt_keep", 2)),
                )
        return step

    def validate(self, step: int = 0, max_batches: int | None = None, log: bool = True) -> float:
        """Average ``val_step`` metrics over up to ``max_batches`` batches;
        returns the ``valid_monitor_key`` metric."""
        cfg = self.cfg
        max_batches = max_batches or int(cfg.get("eval_max_batches", 100))
        meters = MeterBank()
        for i, batch in enumerate(self.task.val_batches()):
            if i >= max_batches:
                break
            meters.update(self.task.val_step(batch))
        avgs = meters.averages()
        if log and avgs:
            self.logger.log_scalars(avgs, step, prefix="val/")
            print(f"| validation @ {step}: " + ", ".join(
                f"{k}={v:.4g}" for k, v in sorted(avgs.items())), flush=True)
        key = cfg.get("valid_monitor_key", "total_loss")
        return avgs.get(key, avgs.get("total_loss", float("nan")))
