"""wav2vec2 / HuBERT encoder (port of ``geneface_tpu/datagen/wav2vec2.py``).

The conv feature encoder (``feat_extract_norm`` ``"layer"``: a LayerNorm
after every conv; ``"group"``: a per-channel GroupNorm after the first),
the feature projection, the grouped positional convolution and the
transformer, pre-LN with a final LayerNorm (``do_stable_layer_norm``) or
post-LN. With ``vocab_size=0`` there is no CTC head and the model returns
the encoder's hidden states: HuBERT's inference graph. Attention is two
``matmul``s and a softmax, as the JAX package computes it in plain ``jnp``.

Layout: the waveform is ``[B, S]``; hidden states are channel-last
``[B, T, H]``; the feature encoder runs channel-first inside. Submodules
carry the flax names (``feature_encoder.conv_0``, ``layer_<i>.attention.
q_proj``, ...), so :func:`~geneface_tpu_torch.convert.load_flax_variables`
loads a converted checkpoint (``{"config", "params"}``, written by
``tools/convert_hubert_torch.py``) as it is.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from geneface_tpu_torch.models.layers import ChannelLayerNorm, PadConv1d

__all__ = ["Wav2Vec2Config", "Wav2Vec2CTC", "load_wav2vec2_params", "normalize_waveform"]


@dataclass(frozen=True)
class Wav2Vec2Config:
    vocab_size: int = 44
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    conv_dim: tuple = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: tuple = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: tuple = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = True
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = True
    feat_extract_norm: str = "layer"  # "layer" | "group"
    layer_norm_eps: float = 1e-5


class _FeatureEncoder(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        self.norm = c.feat_extract_norm
        cin = 1
        self.n = len(c.conv_dim)
        for i, (dim, stride, kernel) in enumerate(zip(c.conv_dim, c.conv_stride, c.conv_kernel)):
            self.add_module(f"conv_{i}", PadConv1d(cin, dim, kernel, stride, bias=c.conv_bias))
            if self.norm == "layer":
                self.add_module(f"ln_{i}", ChannelLayerNorm(dim, eps=c.layer_norm_eps))
            cin = dim
        if self.norm == "group":
            self.gn_0 = nn.GroupNorm(c.conv_dim[0], c.conv_dim[0], eps=c.layer_norm_eps)

    def forward(self, wav):  # [B, S] → [B, T, C]
        h = wav[:, None, :]
        for i in range(self.n):
            h = getattr(self, f"conv_{i}")(h)
            if self.norm == "layer":
                h = getattr(self, f"ln_{i}")(h)
            elif i == 0:
                h = self.gn_0(h)
            h = F.gelu(h)
        return h.transpose(1, 2)


class _Attention(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        D = c.hidden_size
        self.nh = c.num_attention_heads
        self.q_proj, self.k_proj = nn.Linear(D, D), nn.Linear(D, D)
        self.v_proj, self.out_proj = nn.Linear(D, D), nn.Linear(D, D)

    def forward(self, h):  # [B, T, D]
        B, T, D = h.shape
        hd = D // self.nh

        def heads(t):
            return t.reshape(B, T, self.nh, hd).transpose(1, 2)  # [B, nh, T, hd]

        q = heads(self.q_proj(h) * hd**-0.5)
        k, v = heads(self.k_proj(h)), heads(self.v_proj(h))
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, T, D)
        return self.out_proj(out)


class _EncoderLayer(nn.Module):
    def __init__(self, c: Wav2Vec2Config):
        super().__init__()
        eps = c.layer_norm_eps
        self.stable = c.do_stable_layer_norm
        self.attention = _Attention(c)
        self.layer_norm = nn.LayerNorm(c.hidden_size, eps=eps)
        self.final_layer_norm = nn.LayerNorm(c.hidden_size, eps=eps)
        self.ff_intermediate = nn.Linear(c.hidden_size, c.intermediate_size)
        self.ff_output = nn.Linear(c.intermediate_size, c.hidden_size)

    def forward(self, h):
        if self.stable:  # pre-LN
            h = h + self.attention(self.layer_norm(h))
            ff = F.gelu(self.ff_intermediate(self.final_layer_norm(h)))
            return h + self.ff_output(ff)
        h = self.layer_norm(h + self.attention(h))  # post-LN
        ff = F.gelu(self.ff_intermediate(h))
        return self.final_layer_norm(h + self.ff_output(ff))


class Wav2Vec2CTC(nn.Module):
    """``[B, S]`` normalized waveform → hidden states ``[B, T, H]``
    (``vocab_size == 0``) or CTC logits ``[B, T, vocab]``."""

    def __init__(self, cfg: Wav2Vec2Config | None = None):
        super().__init__()
        c = self.cfg = cfg or Wav2Vec2Config()
        eps = c.layer_norm_eps
        self.feature_encoder = _FeatureEncoder(c)
        self.fp_layer_norm = nn.LayerNorm(c.conv_dim[-1], eps=eps)
        self.fp_projection = nn.Linear(c.conv_dim[-1], c.hidden_size)
        K = c.num_conv_pos_embeddings
        # K//2 on both sides, the last step dropped when K is even
        self.pos_conv = PadConv1d(c.hidden_size, c.hidden_size, K, pad=(K // 2, K // 2),
                                  groups=c.num_conv_pos_embedding_groups)
        self.encoder_layer_norm = nn.LayerNorm(c.hidden_size, eps=eps)
        for i in range(c.num_hidden_layers):
            self.add_module(f"layer_{i}", _EncoderLayer(c))
        if c.vocab_size:
            self.lm_head = nn.Linear(c.hidden_size, c.vocab_size)

    def forward(self, wav):
        c = self.cfg
        h = self.fp_projection(self.fp_layer_norm(self.feature_encoder(wav)))
        pos = self.pos_conv(h.transpose(1, 2)).transpose(1, 2)
        if c.num_conv_pos_embeddings % 2 == 0:
            pos = pos[:, :-1]
        h = h + F.gelu(pos)
        if not c.do_stable_layer_norm:
            h = self.encoder_layer_norm(h)
        for i in range(c.num_hidden_layers):
            h = getattr(self, f"layer_{i}")(h)
        if c.do_stable_layer_norm:
            h = self.encoder_layer_norm(h)
        return self.lm_head(h) if c.vocab_size else h


def normalize_waveform(wav: np.ndarray) -> np.ndarray:
    """Zero mean, unit variance (HF ``Wav2Vec2FeatureExtractor``,
    ``do_normalize=True``, as hubert-large ships)."""
    wav = np.asarray(wav, np.float32)
    return (wav - wav.mean()) / np.sqrt(wav.var() + 1e-7)


def load_wav2vec2_params(path: str) -> tuple:
    """A converted checkpoint ``{"config": dict, "params": flax variables}``
    → ``(Wav2Vec2Config, variables)`` (numpy leaves; read through the
    port's restricted unpickler)."""
    from geneface_tpu_torch.utils.checkpoint import load_checkpoint

    payload = load_checkpoint(path)
    cfg = dict(payload["config"])
    for k in ("conv_dim", "conv_stride", "conv_kernel"):
        cfg[k] = tuple(int(x) for x in cfg[k])
    return Wav2Vec2Config(**cfg), payload["params"]
