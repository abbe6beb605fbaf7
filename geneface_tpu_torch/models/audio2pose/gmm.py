"""GMM loss and sampling for audio2pose (port of
``geneface_tpu/models/audio2pose/gmm.py``, reference
``modules/audio2pose/gmm_utils.py``).

The randomness of :func:`sample_gmm` is explicit: the categorical choice
``sel`` and the normal ``noise`` are tensors the caller passes, or are drawn
from a ``torch.Generator``.
"""

from __future__ import annotations

import torch

__all__ = ["gmm_log_loss", "sample_gmm"]


def gmm_log_loss(output: torch.Tensor, target: torch.Tensor, ncenter: int = 1,
                 ndim: int = 12) -> torch.Tensor:
    """The GMM "log loss" as the reference ships it (``gmm_utils.py:65``):
    the mean squared difference of the target and every center's mean.

    ``output [B, T, (2·ndim + 1)·ncenter]``: weights, means, then negative
    log sigmas; ``target [B, T, ndim]``."""
    b, T, _ = target.shape
    mus = output[..., ncenter:ncenter + ncenter * ndim].reshape(b, T, ncenter, ndim)
    return torch.mean((target[:, :, None, :] - mus) ** 2)


def sample_gmm(gmm_params: torch.Tensor, ncenter: int, ndim: int,
               generator: torch.Generator | None = None, weight_smooth: float = 0.0,
               sigma_scale: float = 0.0, sel: torch.Tensor | None = None,
               noise: torch.Tensor | None = None) -> torch.Tensor:
    """A sample of GMM params ``[B, T, (2·ndim + 1)·ncenter]`` → ``[B, T,
    ndim]`` (``gmm_utils.py:67-103``): the center ``sel [B·T]`` (drawn from
    the weights' softmax when not given) and ``mu + noise·sigma`` with
    ``sigma = exp(-x)·sigma_scale`` as written, so ``sigma_scale = 0``
    gives the mean unless ``exp(-x)`` overflows (``inf·0`` is NaN, as in
    JAX). ``sel`` and ``noise [B·T, ndim]`` not given are drawn from
    ``generator`` on its device, then moved to the params'."""
    B, T, _ = gmm_params.shape
    flat = gmm_params.reshape(-1, (2 * ndim + 1) * ncenter)
    dev = flat.device
    if sel is None:
        logits = flat[:, :ncenter] * (1 + weight_smooth)
        gdev = generator.device if generator is not None else dev
        probs = torch.softmax(logits.detach().to(gdev), -1)
        sel = torch.multinomial(probs, 1, generator=generator)[:, 0]
    if noise is None:
        gdev = generator.device if generator is not None else dev
        noise = torch.randn(flat.shape[0], ndim, generator=generator, device=gdev)
    sel, noise = sel.to(dev), noise.to(dev, flat.dtype)
    mus = flat[:, ncenter:ncenter + ncenter * ndim].reshape(-1, ncenter, ndim)
    sigmas = torch.exp(-flat[:, ncenter + ncenter * ndim:]).reshape(-1, ncenter, ndim)
    idx = sel.reshape(-1, 1, 1).expand(-1, 1, ndim)
    mu = torch.gather(mus, 1, idx)[:, 0]
    sigma = torch.gather(sigmas, 1, idx)[:, 0] * sigma_scale
    return (mu + noise * sigma).reshape(B, T, ndim)
