"""Post-net inference, stage A of the two-stage pipeline (port of
``geneface_tpu/inference/postnet_infer.py``): wav → HuBERT and f0 → VAE
prior sample → post-net → lm3d ``.npy`` for the RAD-NeRF stage.

The three device stages are separate methods (:meth:`PostnetInfer.sample`,
:meth:`PostnetInfer.refine`; HuBERT in :func:`extract_hubert`) so that each
can be timed; :meth:`PostnetInfer.infer` chains them. The prior noise comes
from ``torch.Generator().manual_seed(seed)`` on the CPU, or is passed in.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from geneface_tpu_torch import resolve_device
from geneface_tpu_torch.inference.audio2motion_infer import (
    load_model_checkpoint,
    prior_noise,
    sample_prior,
    save_npy,
    truncate16,
)
from geneface_tpu_torch.models.audio2motion.vae import PitchContourVAEModel, VAEModel
from geneface_tpu_torch.models.postnet.models import CNNPostNet, PitchContourCNNPostNet
from geneface_tpu_torch.utils.audio import extract_f0, extract_hubert, load_wav16k

__all__ = ["PostnetInfer"]


class PostnetInfer:
    """The VAE from ``audio2motion_work_dir`` (``state["params"]``), the
    post-net from ``postnet_work_dir`` or else the config's own
    ``work_dir`` (``state["gen_params"]``); the pitch variants when
    ``audio2motion_task_cls`` names a pitch task. ``device`` defaults to the
    card."""

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.pitch = "pitch" in cfg.get("audio2motion_task_cls", "").lower()
        norm = cfg.get("postnet_norm", "ln")
        if self.pitch:
            vae = PitchContourVAEModel(in_out_dim=204)
            postnet = PitchContourCNNPostNet(in_out_dim=204, pitch_dim=64, norm=norm)
        else:
            vae = VAEModel(in_out_dim=204)
            postnet = CNNPostNet(in_out_dim=204, norm=norm)
        self.vae = load_model_checkpoint(vae, cfg["audio2motion_work_dir"], "params", self.device)
        pn_dir = cfg.get("postnet_work_dir") or cfg["work_dir"]
        self.postnet = load_model_checkpoint(postnet, pn_dir, "gen_params", self.device)

    def get_cond_from_input(self, wav_path: str) -> tuple:
        """wav → (hubert ``[2T, 1024]``, f0 ``[2T]``), both cut to the same
        multiple of 16 rows."""
        wav = load_wav16k(wav_path)
        hubert = extract_hubert(wav, device=self.device)
        if hubert is None:
            raise RuntimeError(
                "HuBERT checkpoint not available locally; pre-extract features "
                "or provide --hubert_npy"
            )
        f0 = extract_f0(wav)
        T = truncate16(min(len(hubert), len(f0)))
        return hubert[:T], f0[:T]

    @torch.inference_mode()
    def sample(self, hubert: np.ndarray, f0: np.ndarray | None, noise: torch.Tensor,
               temperature: float = 1.0) -> torch.Tensor:
        """The VAE's prior sample → raw landmarks ``[1, T, 204]`` on the device."""
        if self.pitch and f0 is None:
            raise ValueError("pitch postnet inference requires f0")
        with record_function("gf::vae"):
            return sample_prior(self.vae, hubert, noise, self.device, temperature,
                                f0 if self.pitch else None)

    @torch.inference_mode()
    def refine(self, raw: torch.Tensor, f0: np.ndarray | None) -> np.ndarray:
        """The post-net on ``raw`` → lm3d ``[T, 68, 3]``."""
        with record_function("gf::postnet"):
            if self.pitch:
                pitch = self.vae.pitch_features(torch.as_tensor(f0, device=self.device)[None])
                refined = self.postnet(raw, pitch)
            else:
                refined = self.postnet(raw)
        return refined[0].cpu().numpy().reshape(-1, 68, 3)

    def infer(self, wav_path: str | None = None, hubert: np.ndarray | None = None,
              f0: np.ndarray | None = None, out_npy: str | None = None,
              temperature: float = 1.0, seed: int = 0,
              noise: torch.Tensor | None = None) -> np.ndarray:
        """→ predicted idexp lm3d ``[T, 68, 3]``; ``out_npy`` gets it as
        ``[1, T, 68, 3]``."""
        if hubert is None:
            hubert, f0 = self.get_cond_from_input(wav_path)
        if noise is None:
            noise = prior_noise(self.vae, len(hubert) // 2, seed)
        lm3d = self.refine(self.sample(hubert, f0, noise, temperature), f0)
        if out_npy:
            save_npy(out_npy, lm3d[None])
        return lm3d
