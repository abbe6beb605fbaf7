"""The post-net task, inference side (port of the ``--infer`` entry of
``geneface_tpu/tasks/postnet.py``).

``python -m geneface_tpu_torch.tasks.run --config <postnet yaml> --infer``
runs stage A: wav → HuBERT and f0 → VAE prior sample → post-net → the lm3d
``.npy`` (``infer_out_npy_name``) that the RAD-NeRF ``--infer`` renders
from. ``infer_hubert_npy`` (and ``infer_f0_npy`` for the pitch variant)
give pre-extracted features instead of the live HuBERT. Training the task
(the adversarial and SyncNet losses) is not ported.
"""

from __future__ import annotations

import numpy as np

from geneface_tpu_torch.inference.audio2motion_infer import truncate16
from geneface_tpu_torch.inference.postnet_infer import PostnetInfer
from geneface_tpu_torch.training.trainer import Task

__all__ = ["PostnetAdvSyncTask"]


class PostnetAdvSyncTask(Task):
    def __init__(self, cfg, device=None):
        super().__init__(cfg)
        self.device = device

    def build(self) -> None:
        raise NotImplementedError(
            "post-net training (adversarial + SyncNet losses) is not ported; "
            "run with --infer"
        )

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
