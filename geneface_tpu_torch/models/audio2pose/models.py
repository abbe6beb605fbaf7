"""Audio2Pose: a conditioned WaveNet that emits the GMM parameters of the
head pose (port of ``geneface_tpu/models/audio2pose/models.py``, reference
``modules/audio2pose/models.py``).

An audio MLP encoder (two dense layers, LeakyReLU 0.2) conditions a gated
WaveNet of dilated causal convolutions over the 12-D (pose, velocity)
history; it outputs the ``(2·12 + 1)``-D GMM parameters of each step.
:func:`autoregressive_infer` rolls a receptive-field window over the audio
and feeds each step's sample back into the history.

The model is channel-last at its boundary (``[B, T, C]``, as the flax
model); inside, the convolutions are ``Conv1d`` on ``[B, C, T]``, each
causal: ``(k − 1)·d`` zeros on the left, then a ``VALID`` dilated conv.
Submodules carry the flax names (``audio_fc1``, ``backbone.block_<i>.
filter``, ...), so :func:`~geneface_tpu_torch.convert.load_flax_variables`
reads a JAX checkpoint's ``params`` as they are. The activations call
``F.leaky_relu`` through this module's ``F``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from geneface_tpu_torch.models.audio2pose.gmm import sample_gmm

__all__ = ["Audio2PoseModel", "WaveNet", "autoregressive_infer"]


def _act(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class _ResidualBlock(nn.Module):
    def __init__(self, dilation: int, dilation_channels: int = 128, residual_channels: int = 128,
                 skip_channels: int = 256, kernel_size: int = 2, use_bias: bool = True,
                 cond_channels: int = 256):
        super().__init__()
        self.pad = (kernel_size - 1) * dilation
        self.filter = nn.Conv1d(residual_channels, dilation_channels, kernel_size,
                                dilation=dilation, bias=use_bias)
        self.gate = nn.Conv1d(residual_channels, dilation_channels, kernel_size,
                              dilation=dilation, bias=use_bias)
        self.cond_filter = nn.Conv1d(cond_channels, dilation_channels, 1)
        self.cond_gate = nn.Conv1d(cond_channels, dilation_channels, 1)
        self.res = nn.Conv1d(dilation_channels, residual_channels, 1, bias=use_bias)
        self.skip = nn.Conv1d(dilation_channels, skip_channels, 1, bias=use_bias)

    def forward(self, x: torch.Tensor, cond: torch.Tensor | None) -> tuple:
        """``x [B, R, T]``; ``cond [B, C, T]`` → (residual, skip), channel-first."""
        xp = F.pad(x, (self.pad, 0))
        filt = self.filter(xp)
        gate = self.gate(xp)
        if cond is not None:
            filt = filt + self.cond_filter(cond)
            gate = gate + self.cond_gate(cond)
        act = torch.tanh(filt) * torch.sigmoid(gate)
        return self.res(act) + x, self.skip(act)


class WaveNet(nn.Module):
    def __init__(self, residual_layers: int = 3, residual_blocks: int = 2,
                 dilation_channels: int = 128, residual_channels: int = 128,
                 skip_channels: int = 256, kernel_size: int = 2, input_channels: int = 12,
                 output_channels: int = (2 * 12 + 1) * 1, cond_channels: int = 256):
        super().__init__()
        self.residual_layers, self.residual_blocks = residual_layers, residual_blocks
        self.kernel_size = kernel_size
        self.start1 = nn.Conv1d(input_channels, residual_channels, 1)
        self.start2 = nn.Conv1d(residual_channels, residual_channels, 1)
        b_idx = 0
        for _ in range(residual_blocks):
            dilation = 1
            for _ in range(residual_layers):
                self.add_module(f"block_{b_idx}", _ResidualBlock(
                    dilation, dilation_channels, residual_channels, skip_channels,
                    kernel_size, cond_channels=cond_channels))
                dilation *= 2
                b_idx += 1
        self.n_blocks = b_idx
        self.end1 = nn.Conv1d(skip_channels, output_channels, 1)
        self.end2 = nn.Conv1d(output_channels, output_channels, 1)

    def forward(self, x: torch.Tensor, cond: torch.Tensor | None = None) -> torch.Tensor:
        """``x [B, T, 12]`` pose+velocity history; ``cond [B, T, 256]`` →
        GMM params ``[B, T, 25]``."""
        h = _act(self.start1(x.transpose(1, 2)))
        h = _act(self.start2(h))
        c = None if cond is None else cond.transpose(1, 2)
        skip = 0.0
        for i in range(self.n_blocks):
            h, s = getattr(self, f"block_{i}")(h, c)
            skip = skip + s
        out = _act(self.end1(_act(skip)))
        return self.end2(out).transpose(1, 2)

    @property
    def receptive_field(self) -> int:
        rf, scope = 1, self.kernel_size - 1
        for _ in range(self.residual_blocks):
            s = scope
            for _ in range(self.residual_layers):
                rf += s
                s *= 2
        return rf


class Audio2PoseModel(nn.Module):
    def __init__(self, recept_field: int = 100, audio_in_dim: int = 2 * 29):
        super().__init__()
        self.recept_field = recept_field
        self.audio_in_dim = audio_in_dim
        self.audio_fc1 = nn.Linear(audio_in_dim, 256)
        self.audio_fc2 = nn.Linear(256, 256)
        self.backbone = WaveNet()

    def encode_audio(self, audio: torch.Tensor) -> torch.Tensor:
        return self.audio_fc2(_act(self.audio_fc1(audio)))

    def forward(self, audio: torch.Tensor, history_pose_velocity: torch.Tensor) -> torch.Tensor:
        """``audio [B, T, audio_in_dim]``; history ``[B, T, 12]`` → GMM
        params ``[B, T, 25]``."""
        with record_function("gf::audio2pose"):
            return self.backbone(history_pose_velocity, self.encode_audio(audio))


@torch.no_grad()
def autoregressive_infer(model: Audio2PoseModel, long_audio: torch.Tensor,
                         init_pose=None, generator: torch.Generator | None = None,
                         noise: torch.Tensor | None = None) -> torch.Tensor:
    """``long_audio [T, audio_in_dim]`` → predicted pose ``[T, 6]``
    (``models.py:36-62`` of the reference).

    A loop over frames: each feeds the receptive-field window of the audio
    (the first row repeated ``R − 1`` times in front) and the rolling
    ``[R, 12]`` history (zeros, its pose columns ``init_pose``) and samples
    the single-center GMM with ``sigma_scale = 0`` (the mean). ``noise
    [T, 12]`` is the normal noise of the samples (drawn from ``generator``
    on the CPU when not given); it only shows where ``exp(−x)`` overflows.
    """
    R = model.recept_field
    T = long_audio.shape[0]
    dev = long_audio.device
    audio = torch.cat([long_audio[:1].expand(R - 1, -1), long_audio], 0)
    idx = torch.arange(T, device=dev)[:, None] + torch.arange(R, device=dev)[None, :]
    windows = audio[idx]  # [T, R, C]
    history = torch.zeros(R, 12, device=dev)
    if init_pose is not None:
        history[:, :6] = torch.as_tensor(init_pose, dtype=torch.float32, device=dev)[None, :]
    if noise is None:
        noise = torch.randn(T, 12, generator=generator)
    noise = noise.to(dev)
    sel = torch.zeros(1, dtype=torch.long, device=dev)  # the one center
    samples = []
    with record_function("gf::audio2pose_rollout"):
        for t in range(T):
            gmm = model(windows[t][None], history[None])[0, -1]
            sample = sample_gmm(gmm[None, None], 1, 12, sigma_scale=0.0, sel=sel,
                                noise=noise[t][None])[0, 0]
            history = torch.cat([history[1:], sample[None]], 0)
            samples.append(sample)
    return torch.stack(samples)[:, :6] if samples else history.new_zeros(0, 6)
