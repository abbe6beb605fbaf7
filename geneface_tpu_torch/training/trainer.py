"""Task protocol and the training loop (port of
``geneface_tpu/training/trainer.py``, one device, no mesh).

A :class:`Task` owns its model, optimizer and auxiliary state;
:meth:`Trainer.fit` restores the newest checkpoint of the work dir (or
``resume_from_checkpoint``'s step) when there is one, else runs the sanity
validation, then the steps, the periodic validation (with the task's
``on_validation_end``) and the checkpoints: ``model_ckpt_steps_<n>.ckpt`` in
the JAX layout, the newest ``num_ckpt_keep`` kept, and
``model_ckpt_best.ckpt`` when the ``valid_monitor_key`` metric improves
(``save_best``, ``valid_monitor_mode``). It logs to
``<work_dir>/metrics.jsonl`` and ``images/``; ``tee_logs`` mirrors the
terminal to ``terminal_logs/``, ``save_codes`` copies the package's sources
to ``codes/<ts>/``, ``profile_steps`` traces that many steps from
``profile_start_step`` with ``torch.profiler`` to ``profile/``. Step metrics
stay on the device until a log step reads them. As in the JAX trainer, a
resumed run re-seeds everything else (data order, noise) from ``seed``.
"""

from __future__ import annotations

import os
import shutil
import sys
import time
from datetime import datetime
from typing import Iterator

from geneface_tpu_torch.config.config import save_config
from geneface_tpu_torch.utils.checkpoint import CheckpointManager
from geneface_tpu_torch.utils.logging import MetricsLogger
from geneface_tpu_torch.utils.meters import MeterBank

__all__ = ["Task", "Trainer", "tee_terminal_logs", "snapshot_code"]


class Task:
    """Subclass and implement ``build``, ``train_step``, ``val_step``,
    ``train_batches``, ``val_batches``, ``checkpoint_payload`` and
    ``restore_state``; the ``on_*`` hooks are optional."""

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

    def train_batches(self, start_step: int = 0) -> Iterator:
        raise NotImplementedError

    def val_batches(self) -> Iterator:
        raise NotImplementedError

    def checkpoint_payload(self, step: int) -> dict:
        """``{"step", "state", "extra": on_save()}`` in the JAX layout."""
        raise NotImplementedError

    def restore_state(self, state: dict) -> None:
        """Load a checkpoint's ``state`` (parameters, occupancy, optimizer)."""
        raise NotImplementedError

    def on_save(self) -> dict:
        """Extra host-side payload checkpointed beside the state."""
        return {}

    def on_restore(self, extra: dict) -> None:
        """Take back what :meth:`on_save` wrote."""

    def on_validation_end(self, step: int, logger: MetricsLogger) -> None:
        """Called after each logged validation: tasks may log artifacts
        such as a rendered val frame."""

    @classmethod
    def run_inference(cls, cfg, device=None):
        """The ``--infer`` entry of the task family (overridden per task)."""
        raise NotImplementedError(f"{cls.__name__} has no inference pipeline")


class _Tee:
    def __init__(self, stream, f):
        self.stream, self.f = stream, f

    def write(self, data):
        self.stream.write(data)
        self.f.write(data)

    def flush(self):
        self.stream.flush()
        self.f.flush()


def tee_terminal_logs(work_dir: str):
    """Mirror stdout and stderr to ``work_dir/terminal_logs/log_<ts>.txt``;
    returns the open log file (later calls stack)."""
    log_dir = os.path.join(work_dir, "terminal_logs")
    os.makedirs(log_dir, exist_ok=True)
    f = open(os.path.join(log_dir, f"log_{datetime.now():%Y%m%d%H%M%S}.txt"), "a",
             buffering=1)
    sys.stdout = _Tee(sys.stdout, f)
    sys.stderr = _Tee(sys.stderr, f)
    return f


def snapshot_code(work_dir: str, src_root: str | None = None) -> str:
    """Copy the package's sources (``.py``, ``.yaml``, ``.cu``) into
    ``work_dir/codes/<ts>/`` → that directory."""
    if src_root is None:
        src_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(work_dir, "codes", f"{datetime.now():%Y%m%d%H%M%S}")
    for root, _dirs, files in os.walk(src_root):
        if any(p in root for p in ("__pycache__", ".git", "checkpoints", "build")):
            continue
        rel = os.path.relpath(root, src_root)
        for name in files:
            if name.endswith((".py", ".yaml", ".yml", ".cu")):
                os.makedirs(os.path.join(dst, rel), exist_ok=True)
                shutil.copy2(os.path.join(root, name), os.path.join(dst, rel, name))
    return dst


class Trainer:
    def __init__(self, task: Task):
        self.task = task
        self.cfg = task.cfg
        self.work_dir = self.cfg.get("work_dir") or os.path.join(
            "checkpoints", self.cfg.get("exp_name", "default")
        )
        os.makedirs(self.work_dir, exist_ok=True)
        save_config(self.cfg, self.work_dir)
        if self.cfg.get("tee_logs", False):
            tee_terminal_logs(self.work_dir)
        if self.cfg.get("save_codes", False):
            snapshot_code(self.work_dir)
        self.logger = MetricsLogger(self.work_dir)
        self.ckpt = CheckpointManager(
            self.work_dir, num_keep=self.cfg.get("num_ckpt_keep", 2),
            save_best=self.cfg.get("save_best", True),
            mode=self.cfg.get("valid_monitor_mode", "min"),
        )

    def fit(self) -> int:
        """Train to ``max_updates`` (from the restored step, if any);
        returns the last step."""
        cfg = self.cfg
        task = self.task
        task.build()
        step = 0
        restored = self.ckpt.restore(cfg.get("resume_from_checkpoint", 0) or None)
        if restored is not None:
            step = int(restored["step"])
            task.restore_state(restored["state"])
            task.on_restore(restored.get("extra", {}))
            print(f"| resumed from step {step}", flush=True)
        n_sanity = int(cfg.get("num_sanity_val_steps", 2))
        if n_sanity and restored is None:
            self.validate(step=step, max_batches=n_sanity, log=False)
        max_updates = int(cfg.get("max_updates", 10000))
        val_interval = int(cfg.get("val_check_interval", 2000))
        log_interval = int(cfg.get("tb_log_interval", 100))
        prof_steps = int(cfg.get("profile_steps", 0))
        prof_start = int(cfg.get("profile_start_step", 10))
        prof = None
        pending = []
        t_last = time.time()
        train_iter = task.train_batches(step)
        try:
            while step < max_updates:
                if prof_steps and step == prof_start:
                    prof = self._start_profile()
                pending.append(task.train_step(next(train_iter)))
                step += 1
                if prof is not None and step == prof_start + prof_steps:
                    self._stop_profile(prof, prof_start, step)
                    prof = None
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
                    val_metric = self.validate(step=step)
                    self.ckpt.save(step, task.checkpoint_payload(step), val_metric=val_metric)
        finally:
            if prof is not None:  # the run ended inside the traced steps
                self._stop_profile(prof, prof_start, step)
        return step

    def _start_profile(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        self._prof_cuda = getattr(getattr(self.task, "device", None), "type", "") == "cuda"
        if self._prof_cuda:
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        prof = profile(activities=acts)
        prof.__enter__()
        return prof

    def _stop_profile(self, prof, first: int, end: int) -> None:
        """Close the trace of steps ``[first, end)`` and write it to
        ``<work_dir>/profile/trace_steps_<first>_<end>.json`` (Chrome trace
        format)."""
        import torch

        if self._prof_cuda:
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        out = os.path.join(self.work_dir, "profile")
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"trace_steps_{first}_{end}.json")
        prof.export_chrome_trace(path)
        print(f"| wrote the trace of steps {first}-{end - 1} to {path}", flush=True)

    def validate(self, step: int = 0, max_batches: int | None = None, log: bool = True) -> float:
        """Average ``val_step`` metrics over up to ``max_batches`` batches;
        a logged validation ends with the task's ``on_validation_end``.
        Returns the ``valid_monitor_key`` metric."""
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
            self.task.on_validation_end(step, self.logger)
        key = cfg.get("valid_monitor_key", "total_loss")
        return avgs.get(key, avgs.get("total_loss", float("nan")))
