"""ASR conditions: the esperanto wav2vec2 CTC windows and the DeepSpeech
windows (port of ``geneface_tpu/datagen/asr_features.py``).

Counterpart of the reference's two extractors:

- ``data_util/extract_esperanto.py``: wav2vec2 CTC logits (the esperanto
  vocabulary, 44 classes) at 50 fps → ``esperanto_win [T, 16, 44]``;
- ``data_util/deepspeech_features/``: the frozen DeepSpeech graph's logits
  (29 classes) → ``deepspeech_win [T, 16, 29]``.

Both end in :func:`logits_to_windows` (numpy, a copy of the JAX package's:
the same windows bit for bit). The forwards run on the port's
:class:`~geneface_tpu_torch.datagen.wav2vec2.Wav2Vec2CTC` (a converted
checkpoint) and :class:`~geneface_tpu_torch.datagen.deepspeech.DeepSpeechNet`
(the frozen ``.pb``), on the card unless ``device="cpu"``. The JAX
package's fallbacks are not ported: without a converted esperanto checkpoint
there is no ``transformers`` forward, and a graph the mapper cannot read
raises its ``ValueError`` instead of running the graph in TensorFlow.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.profiler import record_function

__all__ = [
    "logits_to_windows",
    "extract_esperanto_features",
    "extract_deepspeech_features",
    "load_esperanto",
    "ESPERANTO_DIM",
    "DEEPSPEECH_DIM",
]

ESPERANTO_DIM = 44
DEEPSPEECH_DIM = 29
ESPERANTO_MODEL = "cpierse/wav2vec2-large-xlsr-53-esperanto"


def logits_to_windows(
    logits: np.ndarray,  # [T50, D] per-20ms ASR logits
    win_size: int = 16,
    stride: int = 2,
    n_frames: int | None = None,
) -> np.ndarray:
    """50 fps logits → [T25, win, D] sliding windows
    (``deepspeech_features.py:66-74``: pad win/2 both sides, stride 2).

    ``n_frames`` trims/pads the output to the video frame count.
    """
    logits = np.asarray(logits, np.float32)
    half = win_size // 2
    zp = np.zeros((half, logits.shape[1]), np.float32)
    padded = np.concatenate([zp, logits, zp], 0)
    n_win = max((padded.shape[0] - win_size) // stride + 1, 0)
    wins = np.stack(
        [padded[i * stride : i * stride + win_size] for i in range(n_win)]
    ) if n_win else np.zeros((0, win_size, logits.shape[1]), np.float32)
    if n_frames is not None:
        if len(wins) >= n_frames:
            wins = wins[:n_frames]
        else:
            pad = np.repeat(wins[-1:], n_frames - len(wins), 0) if len(wins) else (
                np.zeros((n_frames, win_size, logits.shape[1]), np.float32)
            )
            wins = np.concatenate([wins, pad], 0)
    return wins


def esperanto_checkpoint(flax_ckpt: str | None = None) -> str:
    """``flax_ckpt``, else ``GF_W2V2_ESPERANTO``; raises ``RuntimeError``
    without either."""
    path = flax_ckpt or os.environ.get("GF_W2V2_ESPERANTO", "")
    if not path:
        raise RuntimeError(
            f"esperanto wav2vec2 checkpoint '{ESPERANTO_MODEL}' unavailable: convert it with "
            "tools/convert_wav2vec2_torch.py and pass flax_ckpt= or set GF_W2V2_ESPERANTO "
            "(the port has no transformers fallback)")
    return path


def load_esperanto(flax_ckpt: str | None = None, device=None) -> torch.nn.Module:
    """The converted esperanto ``Wav2Vec2CTC`` in eval mode on ``device``
    (the card by default)."""
    from geneface_tpu_torch import resolve_device
    from geneface_tpu_torch.utils.audio import load_hubert

    return load_hubert(esperanto_checkpoint(flax_ckpt), resolve_device(device))


@torch.inference_mode()
def extract_esperanto_features(
    wav: np.ndarray,
    n_frames: int | None = None,
    flax_ckpt: str | None = None,
    device=None,
    model: torch.nn.Module | None = None,
) -> np.ndarray:
    """wav @16k → ``esperanto_win`` [T, 16, 44]
    (``data_util/extract_esperanto.py:47-51``; vocab 44). ``flax_ckpt``
    (or ``GF_W2V2_ESPERANTO``): the converted checkpoint; ``model`` (from
    :func:`load_esperanto`) skips reading it."""
    from geneface_tpu_torch.datagen.wav2vec2 import normalize_waveform

    if model is None:
        model = load_esperanto(flax_ckpt, device)
    dev = next(model.parameters()).device
    x = torch.from_numpy(normalize_waveform(wav)).to(dev)[None]
    with record_function("gf::esperanto"):
        logits = model(x)[0].float().cpu().numpy()
    return logits_to_windows(logits[:, :ESPERANTO_DIM], n_frames=n_frames)


def extract_deepspeech_features(
    wav: np.ndarray,
    n_frames: int | None = None,
    graph_pb: str | None = None,
    device=None,
    net: torch.nn.Module | None = None,
) -> np.ndarray:
    """wav @16k → ``deepspeech_win`` [T, 16, 29]: the MFCC context windows
    (host, numpy), the frozen graph's net (``graph_pb``, or
    ``GF_DEEPSPEECH_PB``; ``net`` from ``load_deepspeech`` skips reading
    it), the windows. Without a graph it raises ``RuntimeError``; a graph
    the mapper cannot identify raises its ``ValueError``."""
    from geneface_tpu_torch.datagen._ds_audio import audio_to_mfcc_windows
    from geneface_tpu_torch.datagen.deepspeech import deepspeech_logits

    graph_pb = graph_pb or os.environ.get("GF_DEEPSPEECH_PB", "")
    if not graph_pb and net is None:
        raise RuntimeError(
            "deepspeech features need the frozen graph "
            "(deepspeech-0_1_0-b90017e8.pb); pass graph_pb= or set "
            "GF_DEEPSPEECH_PB"
        )
    feats, _n = audio_to_mfcc_windows(wav)
    logits = deepspeech_logits(graph_pb, feats, device=device, net=net)
    return logits_to_windows(logits.reshape(-1, DEEPSPEECH_DIM), n_frames=n_frames)
