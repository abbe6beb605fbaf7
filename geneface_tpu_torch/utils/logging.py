"""Scalar metrics as JSON lines and images as files (port of
``geneface_tpu/utils/logging.py`` without its TensorBoard writer): one
``{"step", "ts", <prefix><name>...}`` object per call, appended to
``<work_dir>/metrics.jsonl``; an image to
``<work_dir>/images/<tag>/step_<n>.png`` (``.npy`` without PIL)."""

from __future__ import annotations

import json
import os
import time

import numpy as np

__all__ = ["MetricsLogger"]


class MetricsLogger:
    def __init__(self, work_dir: str):
        self.work_dir = work_dir
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

    def log_image(self, tag: str, img, step: int) -> str:
        """``img``: HWC uint8, or float in [0, 1] (a tensor or an array) →
        the path written, ``images/<tag with '/' as '_'>/step_<step>.png``,
        or ``.npy`` when PIL is missing."""
        arr = np.asarray(img.detach().cpu() if hasattr(img, "detach") else img)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        img_dir = os.path.join(self.work_dir, "images", tag.replace("/", "_"))
        os.makedirs(img_dir, exist_ok=True)
        try:
            from PIL import Image
        except ImportError:
            path = os.path.join(img_dir, f"step_{step}.npy")
            np.save(path, arr)
            return path
        path = os.path.join(img_dir, f"step_{step}.png")
        Image.fromarray(arr).save(path)
        return path
