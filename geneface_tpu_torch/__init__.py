"""PyTorch + CUDA port of geneface_tpu: the RAD-NeRF head and torso
(serving and training), the speech-to-landmarks path (HuBERT, the
Audio2Motion VAE, the post-net, the LLE projection; serving and training),
datagen (a person's video to the dataset the head trains on), the vanilla
NeRF, the ASR conditions (DeepSpeech and esperanto windows from a wav, the
streaming ASR) and audio2pose (training and the pose rollout).

The JAX package ``geneface_tpu`` stays the reference; this package mirrors
its layout (``ops/``, ``models/``, ``inference/``, ``data/``, ``datagen/``,
``utils/``, ``config/``) and loads the same pickled checkpoints. It imports
``torch`` and ``numpy`` only — never ``jax``/``flax`` and nothing of
``geneface_tpu`` — and keeps its own copies of the framework-free helpers
it needs.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Every hand-written CUDA kernel sits behind a wrapper that launches it for
CUDA tensors (or raises) and runs the kernel's plain PyTorch version for
CPU tensors, which is what the CPU parity tests exercise.

Precision on the card: float32 matmuls and convolutions run in full float32
(TF32 off, see :func:`set_full_fp32`); the field MLPs round to their
compute dtype (bf16 by default) exactly where the JAX model does.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "set_full_fp32"]


def set_full_fp32() -> None:
    """Turn TF32 off for matmuls and cuDNN convolutions: the JAX reference
    computes float32 products in float32, and TF32 keeps ~3 decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card; a CUDA device without a card raises instead
    of silently running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain PyTorch path"
            )
        set_full_fp32()
    return dev
