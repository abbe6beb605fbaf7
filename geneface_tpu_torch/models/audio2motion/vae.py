"""Audio2Motion VAE (port of ``geneface_tpu/models/audio2motion/vae.py``).

``VAEModel`` and ``PitchContourVAEModel`` encode HuBERT features (plus the
f0 contour for the pitch variant) into a 64- (96-) channel condition at
half the HuBERT rate. ``FVAE`` works at a quarter of that rate:

- training (``FVAE.forward``, ``train=True`` in the models): the posterior
  ``FVAEEncoder`` encodes the landmarks into ``z_q = m_q + ε·exp(logs_q)``,
  the decoder reconstructs them from ``z_q`` (or its attention-pooled style
  with ``sqz_prior``), and the KL is ``log q(z_q) - log N(flow(z_q))``
  through the flow prior run forward, normalized by the latent frames and
  ``latent_size`` (without the flow, the closed form against ``N(0, 1)``);
- inference (``FVAE.infer``): the prior noise through the inverted flow and
  the decoder.

The noise (``ε`` of the posterior, or the prior's) is an explicit tensor:
RNG cannot match across frameworks, so the tasks and the inference classes
draw it from a seeded ``torch.Generator`` and the tests pass the JAX draw
(JAX draws the posterior's from ``split(rng)[0]``).

Layout: the models take the JAX batch (channel-last ``hubert [B, 2T,
1024]``, ``f0 [B, 2T]``, ``y [B, T, C]``, ``y_mask [B, T]``) and noise
``[B, T_sqz, 16]``, and return channel-last ``pred [B, T, C]``, ``z_p`` and
``m_q`` ``[B, T_sqz, 16]``; inside everything is channel-first
``[B, C, T]``. Submodules carry the flax names.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from geneface_tpu_torch.models.audio2motion.flow import WN, ResidualCouplingBlock
from geneface_tpu_torch.models.layers import PadConv1d, channel_norm, same_padding
from geneface_tpu_torch.utils.pitch import f0_to_coarse

__all__ = ["FVAE", "FVAEEncoder", "FVAEDecoder", "VAEModel", "PitchContourVAEModel"]


def _strided_pre(cin: int, cout: int, s: int) -> PadConv1d:
    """Kernel ``2s``, stride ``s``, padding ``(s//2, s - s//2)``."""
    return PadConv1d(cin, cout, 2 * s, stride=s, pad=(s // 2, s - s // 2))


class FVAEEncoder(nn.Module):
    def __init__(self, in_channels: int, hidden_channels: int, latent_channels: int,
                 kernel_size: int, n_layers: int, gin_channels: int = 0, strides: tuple = (4,)):
        super().__init__()
        self.strides = tuple(strides)
        for i, s in enumerate(self.strides):
            self.add_module(f"pre_{i}", _strided_pre(in_channels if i == 0 else hidden_channels,
                                                     hidden_channels, s))
        self.wn = WN(hidden_channels, kernel_size, 1, n_layers, gin_channels)
        self.out = PadConv1d(hidden_channels, 2 * latent_channels, 1)

    def forward(self, x, x_mask, g, noise):
        """x [B, C_in, T], x_mask [B, 1, T], g [B, C_g, T_sqz], noise like
        ``m`` → (z, m, logs, mask_sqz)."""
        for i in range(len(self.strides)):
            x = getattr(self, f"pre_{i}")(x)
        total = 1
        for s in self.strides:
            total *= s
        mask = x_mask[:, :, ::total][:, :, : x.shape[2]]
        x = x * mask
        x = self.wn(x, mask, g) * mask
        m, logs = self.out(x).chunk(2, dim=1)
        return m + noise * torch.exp(logs), m, logs, mask


class FVAEDecoder(nn.Module):
    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int,
                 kernel_size: int, n_layers: int, gin_channels: int = 0, strides: tuple = (4,)):
        super().__init__()
        self.n_pre = len(strides)
        for i, s in enumerate(strides):
            # flax ConvTranspose(kernel s, stride s, SAME); convert.py
            # reverses the kernel along K for torch's operator
            self.add_module(f"pre_{i}", nn.ConvTranspose1d(
                in_channels if i == 0 else hidden_channels, hidden_channels, s, stride=s))
        self.wn = WN(hidden_channels, kernel_size, 1, n_layers, gin_channels)
        self.out = PadConv1d(hidden_channels, out_channels, 1)

    def forward(self, z, x_mask, g):
        """z [B, C_z, T_sqz], x_mask [B, 1, T], g [B, C_g, T] → [B, C_out, T]."""
        x = z
        for i in range(self.n_pre):
            x = getattr(self, f"pre_{i}")(x)
        x = x * x_mask
        x = self.wn(x, x_mask, g) * x_mask
        return self.out(x)


class FVAE(nn.Module):
    def __init__(self, in_out_channels: int = 64, hidden_channels: int = 256,
                 latent_size: int = 16, kernel_size: int = 5, enc_n_layers: int = 8,
                 dec_n_layers: int = 4, gin_channels: int = 64, strides: tuple = (4,),
                 use_prior_glow: bool = True, glow_hidden: int = 64, glow_kernel_size: int = 3,
                 glow_n_blocks: int = 4, sqz_prior: bool = False):
        super().__init__()
        s = strides[0]
        self.latent_size = latent_size
        self.sqz_prior = sqz_prior
        self.use_prior_glow = use_prior_glow
        self.g_pre_net = _strided_pre(gin_channels, gin_channels, s)
        self.encoder = FVAEEncoder(in_out_channels, hidden_channels, latent_size, kernel_size,
                                   enc_n_layers, gin_channels, strides)
        self.decoder = FVAEDecoder(hidden_channels if sqz_prior else latent_size,
                                   hidden_channels, in_out_channels, kernel_size,
                                   dec_n_layers, gin_channels, strides)
        if use_prior_glow:
            self.prior_flow = ResidualCouplingBlock(
                latent_size, glow_hidden, glow_kernel_size, 1, glow_n_blocks, 4,
                gin_channels=gin_channels)
        if sqz_prior:
            self.query_proj = nn.Linear(latent_size, latent_size)
            self.key_proj = nn.Linear(latent_size, latent_size)
            self.value_proj = nn.Linear(latent_size, hidden_channels)

    def latent_length(self, T: int) -> int:
        """Frames of the latent (the strided ``g_pre_net``'s output) for ``T``
        condition frames."""
        c = self.g_pre_net
        return (T + sum(c.pad) - c.kernel_size[0]) // c.stride[0] + 1

    def _style_pool(self, z):
        """Attention pooling of the latent sequence ``[B, L, T]`` to one style
        vector, broadcast back over time → ``[B, H, T]``."""
        zt = z.transpose(1, 2)  # [B, T, L]
        q = self.query_proj(zt.mean(dim=1, keepdim=True))  # [B, 1, L]
        k, v = self.key_proj(zt), self.value_proj(zt)
        attn = torch.softmax(q @ k.transpose(1, 2), dim=-1)  # [B, 1, T]
        return (attn @ v).transpose(1, 2).expand(-1, -1, zt.shape[1])

    def forward(self, x, x_mask, g, noise):
        """Training: x [B, C, T], x_mask [B, 1, T], g [B, C_g, T], noise
        [B, L, T_sqz] standard normal → (x_recon [B, C, T], loss_kl,
        z_p [B, L, T_sqz], m_q, logs_q)."""
        g_sqz = self.g_pre_net(g)
        z_q, m_q, logs_q, mask_sqz = self.encoder(x, x_mask, g_sqz, noise)
        dec_in = self._style_pool(z_q) if self.sqz_prior else z_q
        x_recon = self.decoder(dec_in, x_mask, g)
        if self.use_prior_glow:
            z_p = self.prior_flow(z_q, mask_sqz, g=g_sqz, reverse=False)
            kl = _normal_logprob(z_q, m_q, logs_q) - _normal_logprob(
                z_p, 0.0, torch.zeros_like(z_p))
        else:
            z_p = z_q
            kl = -logs_q - 0.5 + 0.5 * (torch.exp(2 * logs_q) + m_q**2)
        loss_kl = ((kl * mask_sqz).sum() / torch.clamp(mask_sqz.sum(), min=1.0)
                   / self.latent_size)
        return x_recon, loss_kl, z_p, m_q, logs_q

    def infer(self, x_mask, g, noise, temperature: float = 1.0):
        """x_mask [B, 1, T], g [B, C_g, T], noise [B, T_sqz, L] standard normal
        → (x_recon [B, C, T], z_p [B, L, T_sqz])."""
        g_sqz = self.g_pre_net(g)
        z_p = noise.transpose(1, 2) * temperature
        if self.use_prior_glow:
            z_p = self.prior_flow(z_p, torch.ones_like(z_p[:, :1]), g=g_sqz, reverse=True)
        dec_in = self._style_pool(z_p) if self.sqz_prior else z_p
        return self.decoder(dec_in, x_mask, g), z_p


def _normal_logprob(x, mean, logs):
    return -0.5 * (math.log(2 * math.pi) + 2 * logs + ((x - mean) ** 2) * torch.exp(-2 * logs))


def _downsample2(x):
    """2× nearest temporal downsample of ``[B, T, ...]``."""
    return x[:, ::2]


class _CondConvEncoder(nn.Module):
    """Channel-last ``[B, T, C_in]`` → channel-first ``[B, C_out, T]``:
    conv 3 → ``ln`` (flax default epsilon 1e-6) or ``bn`` → exact GELU →
    conv 3, both convs without bias."""

    def __init__(self, in_dim: int, out_dim: int = 64, norm: str = "ln"):
        super().__init__()
        self.Conv_0 = PadConv1d(in_dim, 64, 3, pad=same_padding(3), bias=False)
        self.norm_name = "BatchNorm_0" if norm == "bn" else "LayerNorm_0"
        self.add_module(self.norm_name, channel_norm(norm, 64))
        self.Conv_1 = PadConv1d(64, out_dim, 3, pad=same_padding(3), bias=False)

    def forward(self, x):
        norm = getattr(self, self.norm_name)
        x = torch.nn.functional.gelu(norm(self.Conv_0(x.transpose(1, 2))))
        return self.Conv_1(x)


def _vae(in_out_dim: int, gin: int, sqz_prior: bool, use_prior_flow: bool) -> FVAE:
    return FVAE(in_out_channels=in_out_dim, hidden_channels=256, latent_size=16,
                kernel_size=5, enc_n_layers=8, dec_n_layers=4, gin_channels=gin,
                strides=(4,), use_prior_glow=use_prior_flow, glow_hidden=64,
                glow_kernel_size=3, glow_n_blocks=4, sqz_prior=sqz_prior)


class _VAEModelBase(nn.Module):
    hubert_dim = 1024

    def noise_shape(self, batch_size: int, n_frames: int) -> tuple:
        """Shape of the standard-normal noise (the prior's, or the
        posterior's in training) for ``n_frames`` output frames:
        ``(B, T_sqz, 16)``, as the JAX body draws it."""
        return (batch_size, self.vae.latent_length(n_frames), self.vae.latent_size)

    def forward(self, batch, noise, train: bool = False, temperature: float = 1.0):
        """Inference: → ``{"pred" [B, T, C], "mask" [B, T], "z_p" [B, T_sqz,
        16]}``; ``train`` (``batch["y"]`` the landmarks, ``noise`` the
        posterior's): also ``"loss_kl"`` and ``"m_q"``, ``pred`` the
        reconstruction."""
        mask = batch["y_mask"]
        if train:
            x_recon, loss_kl, z_p, m_q, _ = self.vae(
                batch["y"].transpose(1, 2), mask[:, None], self.cond_feats(batch),
                noise.transpose(1, 2))
            return {"pred": x_recon.transpose(1, 2) * mask[..., None], "loss_kl": loss_kl,
                    "mask": mask, "m_q": m_q.transpose(1, 2), "z_p": z_p.transpose(1, 2)}
        x_recon, z_p = self.vae.infer(mask[:, None], self.cond_feats(batch), noise, temperature)
        return {"pred": x_recon.transpose(1, 2) * mask[..., None], "mask": mask,
                "z_p": z_p.transpose(1, 2)}


class VAEModel(_VAEModelBase):
    """HuBERT → landmark-sequence VAE."""

    def __init__(self, in_out_dim: int = 64, sqz_prior: bool = False,
                 use_prior_flow: bool = True, norm: str = "ln"):
        super().__init__()
        self.mel_encoder = _CondConvEncoder(self.hubert_dim, 64, norm)
        self.vae = _vae(in_out_dim, 64, sqz_prior, use_prior_flow)

    def cond_feats(self, batch):
        """→ the condition ``[B, 64, T]`` at half the HuBERT rate."""
        return self.mel_encoder(_downsample2(batch["hubert"]))


class PitchContourVAEModel(_VAEModelBase):
    """``VAEModel`` + the f0 contour: a 300 × 64 pitch embedding of the
    coarse f0 bins through its own condition encoder (→ 32), concatenated
    with the HuBERT condition (gin 96)."""

    def __init__(self, in_out_dim: int = 64, sqz_prior: bool = False,
                 use_prior_flow: bool = True, norm: str = "ln"):
        super().__init__()
        self.mel_encoder = _CondConvEncoder(self.hubert_dim, 64, norm)
        self.pitch_embed = nn.Embedding(300, 64)
        self.pitch_encoder = _CondConvEncoder(64, 32, norm)
        self.vae = _vae(in_out_dim, 96, sqz_prior, use_prior_flow)

    def pitch_features(self, f0):
        """``f0 [B, 2T]`` Hz → the pitch embedding ``[B, T, 64]`` of the
        downsampled contour."""
        return self.pitch_embed(f0_to_coarse(_downsample2(f0)).to(f0.device))

    def cond_feats(self, batch):
        """→ the condition ``[B, 96, T]``: HuBERT's 64 channels, pitch's 32."""
        mel = self.mel_encoder(_downsample2(batch["hubert"]))
        return torch.cat([mel, self.pitch_encoder(self.pitch_features(batch["f0"]))], dim=1)
