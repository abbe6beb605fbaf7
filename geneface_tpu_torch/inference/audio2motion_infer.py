"""Audio2Motion inference: wav → HuBERT → VAE prior sample → lm3d (port of
``geneface_tpu/inference/audio2motion_infer.py``): the generic VAE alone,
without the person-specific post-net.

The prior noise comes from ``torch.Generator().manual_seed(seed)`` on the
CPU (the same draw on every device), or is passed in as ``noise``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from geneface_tpu_torch import resolve_device
from geneface_tpu_torch.convert import load_flax_variables
from geneface_tpu_torch.models.audio2motion.vae import VAEModel
from geneface_tpu_torch.utils.audio import extract_hubert, load_wav16k
from geneface_tpu_torch.utils.checkpoint import get_last_checkpoint, load_checkpoint

__all__ = ["Audio2MotionInfer", "load_model_checkpoint", "prior_noise", "sample_prior", "save_npy",
           "truncate16"]


def load_model_checkpoint(model: torch.nn.Module, work_dir: str, key: str, device):
    """Load the newest ``model_ckpt_steps_*.ckpt`` of ``work_dir`` (its
    ``state[key]``, a flax variables tree) into ``model`` → the model in
    eval mode on ``device``."""
    path = get_last_checkpoint(work_dir)
    if path is None:
        raise FileNotFoundError(f"no model_ckpt_steps_*.ckpt under {work_dir}")
    load_flax_variables(model, load_checkpoint(path)["state"][key])
    return model.to(device).eval()


def prior_noise(vae: VAEModel, n_frames: int, seed: int) -> torch.Tensor:
    """Standard-normal prior noise ``[1, T_sqz, 16]`` for ``n_frames``
    frames from a seeded CPU generator."""
    return torch.randn(vae.noise_shape(1, n_frames),
                       generator=torch.Generator().manual_seed(int(seed)))


def sample_prior(vae: VAEModel, hubert: np.ndarray, noise: torch.Tensor, device,
                 temperature: float = 1.0, f0: np.ndarray | None = None) -> torch.Tensor:
    """The VAE's prior sample for ``hubert`` rows ``[2T, 1024]`` (and
    ``f0`` ``[2T]`` for the pitch VAE) → raw landmarks ``[1, T, 204]`` on
    ``device``."""
    T = len(hubert) // 2
    batch = {"hubert": torch.as_tensor(hubert, device=device)[None],
             "y_mask": torch.ones(1, T, device=device)}
    if f0 is not None:
        batch["f0"] = torch.as_tensor(f0, device=device)[None]
    return vae(batch, noise.to(device), temperature=temperature)["pred"]


def save_npy(out_npy: str, array: np.ndarray) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(out_npy)), exist_ok=True)
    np.save(out_npy, array)


def truncate16(n: int) -> int:
    """HuBERT rows kept: a multiple of 16 (8 landmark frames after the 2×
    downsample, 2 latent frames after the ×4 prior)."""
    return (n // 16) * 16


class Audio2MotionInfer:
    """``device`` defaults to the card."""

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = load_model_checkpoint(
            VAEModel(in_out_dim=cfg.get("motion_dim", 204)), cfg["audio2motion_work_dir"],
            "params", self.device)

    def get_cond_from_input(self, wav_path: str) -> np.ndarray:
        """wav → HuBERT ``[2T, 1024]`` cut to a multiple of 16 rows."""
        hubert = extract_hubert(load_wav16k(wav_path), device=self.device)
        if hubert is None:
            raise RuntimeError("HuBERT checkpoint not available locally; pre-extract features")
        return hubert[: truncate16(len(hubert))]

    @torch.inference_mode()
    def infer(self, wav_path: str | None = None, hubert: np.ndarray | None = None,
              out_npy: str | None = None, temperature: float = 1.0, seed: int = 0,
              noise: torch.Tensor | None = None) -> np.ndarray:
        """→ predicted idexp lm3d ``[T, 68, 3]``; ``out_npy`` gets the
        reference's ``[1, T, 204]`` layout."""
        if hubert is None:
            hubert = self.get_cond_from_input(wav_path)
        if noise is None:
            noise = prior_noise(self.model, len(hubert) // 2, seed)
        pred = sample_prior(self.model, hubert, noise, self.device, temperature)[0].cpu().numpy()
        if out_npy:
            save_npy(out_npy, pred[None])
        return pred.reshape(-1, 68, 3)
