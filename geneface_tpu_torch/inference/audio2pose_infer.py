"""Audio2Pose inference: DeepSpeech windows → the autoregressive pose →
c2w ``.npy`` (port of ``geneface_tpu/inference/audio2pose_infer.py``,
reference ``inference/audio2pose/audio2pose_infer.py:16-152``).

Loads the newest checkpoint of ``audio2pose_work_dir`` (either package's),
rolls :func:`~geneface_tpu_torch.models.audio2pose.autoregressive_infer`
over the audio conditions, adds the dataset's mean translation and turns
(euler, translation) into camera-to-world matrices for the NeRF stage. On
the card unless ``device="cpu"``; the GMM noise comes from
``torch.Generator().manual_seed(seed)`` on the CPU.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from geneface_tpu_torch import resolve_device
from geneface_tpu_torch.inference.audio2motion_infer import load_model_checkpoint
from geneface_tpu_torch.models.audio2pose import Audio2PoseModel, autoregressive_infer
from geneface_tpu_torch.utils.camera import euler_trans_to_c2w

__all__ = ["Audio2PoseInfer"]


class Audio2PoseInfer:
    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = load_model_checkpoint(
            Audio2PoseModel(recept_field=cfg.get("recept_field", 100),
                            audio_in_dim=cfg.get("audio_in_dim", 58)),
            cfg["audio2pose_work_dir"], "params", self.device)
        # dataset statistics used to de-normalize the translation and seed
        # the history window (``audio2pose_infer.py:26-28``)
        stats_path = os.path.join(cfg.get("pose_data_dir", ""), "stats.npz")
        if os.path.exists(stats_path):
            stats = np.load(stats_path)
            self.mean_trans = stats["mean_trans"]
            self.init_pose = stats["init_pose"]
        else:
            self.mean_trans = np.zeros(3, np.float32)
            self.init_pose = np.zeros(6, np.float32)

    def get_cond_from_input(self, deepspeech_npy: str) -> np.ndarray:
        """Pre-extracted deepspeech [T, 16, 29] → center-window features
        [T, 58] (``audio2pose_infer.py:74-91`` uses columns 7:9)."""
        arr = np.load(deepspeech_npy)
        return arr[:, 7:9, :].reshape(len(arr), -1).astype(np.float32)

    def rollout(self, audio_feat: np.ndarray, seed: int = 0) -> np.ndarray:
        """Audio conditions ``[T, audio_in_dim]`` → pose ``[T, 6]`` (numpy)."""
        x = torch.as_tensor(np.asarray(audio_feat, np.float32)).to(self.device)
        pose6 = autoregressive_infer(self.model, x, init_pose=self.init_pose,
                                     generator=torch.Generator().manual_seed(int(seed)))
        return pose6.cpu().numpy()

    def infer(
        self,
        deepspeech_npy: str | None = None,
        audio_feat: np.ndarray | None = None,
        out_npy: str | None = None,
        seed: int = 0,
    ) -> np.ndarray:
        """→ predicted c2w matrices [T, 4, 4]; optionally saved as .npy."""
        if audio_feat is None:
            audio_feat = self.get_cond_from_input(deepspeech_npy)
        pose6 = self.rollout(audio_feat, seed)
        euler, trans = pose6[:, :3], pose6[:, 3:6] + self.mean_trans[None]
        c2w = euler_trans_to_c2w(euler, trans)
        if out_npy:
            os.makedirs(os.path.dirname(os.path.abspath(out_npy)), exist_ok=True)
            np.save(out_npy, c2w)
        return c2w
