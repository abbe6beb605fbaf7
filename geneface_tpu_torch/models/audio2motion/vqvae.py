"""VQ-VAE landmark generator (port of
``geneface_tpu/models/audio2motion/vqvae.py``): ``VectorQuantizer``,
``VQVAE`` and the HuBERT-conditioned ``VQVAEModel``.

The quantizer projects its input to the codebook's width, takes the
nearest code by L2 (``argmin``: the first index on a tie, as in JAX),
projects it back, and passes the gradient straight through; its loss is
the codebook term ``mean((sg(z) − e)²)`` plus β = 0.25 times the
commitment term ``mean((z − sg(e))²)``.

RNG cannot match across frameworks, so the posterior's noise (training)
and the sampled code indices (:meth:`VQVAE.infer`) are explicit tensors,
or drawn from an explicit ``torch.Generator``. Layout: the model takes the
JAX package's channel-last tensors and returns them so; inside, the
convolutions run channel-first. Submodules carry the flax names; the
encoder and decoder are :mod:`vae`'s ``FVAEEncoder``/``FVAEDecoder``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from geneface_tpu_torch.models.audio2motion.vae import FVAEDecoder, FVAEEncoder, _strided_pre
from geneface_tpu_torch.models.layers import PadConv1d, same_padding

__all__ = ["VectorQuantizer", "VQVAE", "VQVAEModel"]


class VectorQuantizer(nn.Module):
    """Projected-codebook vector quantizer on channel-last ``[B, T, dim]``
    → ``(quantized [B, T, dim], indices [B, T], loss)``."""

    def __init__(self, dim: int, codebook_size: int = 256, codebook_dim: int = 16,
                 beta: float = 0.25):
        super().__init__()
        self.beta = beta
        self.codebook = nn.Parameter(torch.randn(codebook_size, codebook_dim))
        self.flax_leaves = {"codebook": (codebook_size, codebook_dim)}
        self.project_in = nn.Linear(dim, codebook_dim)
        self.project_out = nn.Linear(codebook_dim, dim)

    def forward(self, z):
        zp = self.project_in(z)
        dots = torch.einsum("btc,kc->btk", zp, self.codebook)
        e_sq = (self.codebook**2).sum(dim=-1)
        idx = torch.argmin(e_sq[None, None, :] - 2.0 * dots, dim=-1)  # the first on a tie
        e = self.codebook[idx]
        codebook_loss = ((zp.detach() - e) ** 2).mean()
        commit_loss = ((zp - e.detach()) ** 2).mean()
        loss = codebook_loss + self.beta * commit_loss
        e_st = zp + (e - zp).detach()  # straight-through
        return self.project_out(e_st), idx, loss

    def decode_indices(self, idx):
        """Codebook lookup and out-projection of indices ``[B, T]``."""
        return self.project_out(self.codebook[idx])


class VQVAE(nn.Module):
    """Conditional VQ-VAE over landmark sequences (channel-first inside)."""

    def __init__(self, in_out_channels: int = 64, hidden_channels: int = 256,
                 kernel_size: int = 3, enc_n_layers: int = 5, dec_n_layers: int = 5,
                 gin_channels: int = 80, strides: tuple = (4,), codebook_size: int = 256,
                 codebook_dim: int = 16):
        super().__init__()
        self.codebook_size = codebook_size
        self.g_pre_net = _strided_pre(gin_channels, gin_channels, strides[0])
        self.encoder = FVAEEncoder(in_out_channels, hidden_channels, hidden_channels,
                                   kernel_size, enc_n_layers, gin_channels, strides)
        self.vq = VectorQuantizer(hidden_channels, codebook_size, codebook_dim)
        self.decoder = FVAEDecoder(hidden_channels, hidden_channels, in_out_channels,
                                   kernel_size, dec_n_layers, gin_channels, strides)

    def latent_length(self, T: int) -> int:
        c = self.g_pre_net
        return (T + sum(c.pad) - c.kernel_size[0]) // c.stride[0] + 1

    def forward(self, x, x_mask, g, noise):
        """x [B, C, T], x_mask [B, 1, T], g [B, C_g, T], the posterior's
        noise [B, hidden, T_sqz] → (x_recon [B, C, T], loss, zq [B, T_sqz,
        hidden], m_q [B, hidden, T_sqz], logs_q, indices [B, T_sqz])."""
        g_sqz = self.g_pre_net(g)
        z_q, m_q, logs_q, _ = self.encoder(x, x_mask, g_sqz, noise)
        zq, idx, loss = self.vq(z_q.transpose(1, 2))
        x_recon = self.decoder(zq.transpose(1, 2), x_mask, g)
        return x_recon, loss, zq, m_q, logs_q, idx

    def sample_indices(self, g, generator: torch.Generator | None = None):
        """Uniform code indices ``[B, T_sqz]`` for the condition ``g`` (on
        the CPU generator's stream, then moved to ``g``'s device)."""
        shape = (g.shape[0], self.latent_length(g.shape[2]))
        return torch.randint(0, self.codebook_size, shape, generator=generator).to(g.device)

    def infer(self, g, idx):
        """Decode code indices ``idx [B, T_sqz]`` under ``g [B, C_g, T]`` →
        ``[B, C, T]``."""
        zq = self.vq.decode_indices(idx).transpose(1, 2)
        ones = torch.ones(g.shape[0], 1, g.shape[2], dtype=g.dtype, device=g.device)
        return self.decoder(zq, ones, g)


class _AudioEncoder(nn.Module):
    """flax ``nn.Sequential([Conv(64, 3), relu, Conv(64, 3)])``: its
    convolutions are ``layers_0`` and ``layers_2``."""

    def __init__(self, in_dim: int):
        super().__init__()
        self.layers_0 = PadConv1d(in_dim, 64, 3, pad=same_padding(3))
        self.layers_2 = PadConv1d(64, 64, 3, pad=same_padding(3))

    def forward(self, x):
        return self.layers_2(F.relu(self.layers_0(x)))


class VQVAEModel(nn.Module):
    """HuBERT → the VQ-VAE's condition (two 3-conv layers, then the pair
    average of 50 Hz frames down to 25 fps) → ``VQVAE`` over landmarks."""

    def __init__(self, in_out_dim: int = 64, audio_in_dim: int = 1024,
                 hidden_channels: int = 256):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.audio_encoder = _AudioEncoder(audio_in_dim)
        self.vae = VQVAE(in_out_channels=in_out_dim, hidden_channels=hidden_channels,
                         gin_channels=64)

    def cond(self, hubert):
        """``hubert [B, 2T, C]`` → the condition ``[B, 64, T]``."""
        c = self.audio_encoder(hubert.transpose(1, 2))
        n = c.shape[2] // 2
        return 0.5 * (c[:, :, ::2][:, :, :n] + c[:, :, 1::2][:, :, :n])

    def noise_shape(self, batch_size: int, n_frames: int) -> tuple:
        """The posterior noise's shape for ``n_frames`` landmark frames:
        ``(B, T_sqz, hidden)``, as the JAX encoder draws it."""
        return (batch_size, self.vae.latent_length(n_frames), self.hidden_channels)

    def forward(self, hubert, x, x_mask, noise):
        """hubert [B, 2T, C], x [B, T, C_y], x_mask [B, T], noise [B, T_sqz,
        hidden] → ``{"pred" [B, T, C_y], "commit_loss", "z_q" [B, T_sqz,
        hidden], "m_q", "logs_q", "indices"}``."""
        cond = self.cond(hubert)
        T = min(x.shape[1], cond.shape[2])
        x_recon, commit, zq, m_q, logs_q, idx = self.vae(
            x[:, :T].transpose(1, 2), x_mask[:, None, :T], cond[:, :, :T],
            noise.transpose(1, 2))
        return {"pred": x_recon.transpose(1, 2), "commit_loss": commit, "z_q": zq,
                "m_q": m_q.transpose(1, 2), "logs_q": logs_q.transpose(1, 2), "indices": idx}

    def infer(self, hubert, idx=None, generator: torch.Generator | None = None):
        """Decode code indices (given, or uniform from ``generator``) under
        the HuBERT condition → ``[B, T, C_y]``."""
        cond = self.cond(hubert)
        if idx is None:
            idx = self.vae.sample_indices(cond, generator)
        return self.vae.infer(cond, idx).transpose(1, 2)
