"""Scalar metrics as JSON lines (port of ``geneface_tpu/utils/logging.py``
without its TensorBoard writer): one ``{"step", "ts", <prefix><name>...}``
object per call, appended to ``<work_dir>/metrics.jsonl``."""

from __future__ import annotations

import json
import os
import time

__all__ = ["MetricsLogger"]


class MetricsLogger:
    def __init__(self, work_dir: str):
        os.makedirs(work_dir, exist_ok=True)
        self.jsonl_path = os.path.join(work_dir, "metrics.jsonl")

    def log_scalars(self, scalars: dict, step: int, prefix: str = "") -> None:
        clean = {}
        for k, v in scalars.items():
            try:
                clean[f"{prefix}{k}"] = float(v)
            except (TypeError, ValueError, RuntimeError):
                continue
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps({"step": step, "ts": time.time(), **clean}) + "\n")
