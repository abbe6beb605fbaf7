"""Audio IO and features for stage A (port of the parts of
``geneface_tpu/utils/audio.py`` that the speech-to-landmarks path runs):
16 kHz loading, the autocorrelation f0 (a host op, numpy) and the HuBERT
hidden states from a converted checkpoint.

HuBERT reads the converted checkpoint at ``GF_HUBERT_CKPT`` (default
``data/ckpt/hubert.pkl``; ``tools/convert_hubert_torch.py`` writes it). The
port has no ``transformers`` fallback: without a checkpoint
:func:`extract_hubert` returns ``None`` and the inference classes
raise.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np
import torch
import torch.profiler

__all__ = [
    "SR",
    "HOP",
    "load_wav16k",
    "save_wav16k_from_any",
    "extract_f0",
    "hubert_checkpoint",
    "load_hubert",
    "extract_hubert",
]

SR = 16000
HOP = 160  # 100 audio frames per second
WIN = 800


def load_wav16k(path: str) -> np.ndarray:
    """Any audio file → mono float32 at 16 kHz (scipy and a polyphase
    resample; ffmpeg for containers other than wav)."""
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    if not path.endswith(".wav"):
        return load_wav16k(save_wav16k_from_any(path))
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(-1)
    if sr != SR:
        from math import gcd

        g = gcd(sr, SR)
        data = resample_poly(data, SR // g, sr // g).astype(np.float32)
    return data


def save_wav16k_from_any(path: str, out_path: str | None = None) -> str:
    """ffmpeg transcode to a 16 kHz mono wav beside ``path``."""
    out_path = out_path or os.path.splitext(path)[0] + "_16k.wav"
    subprocess.run(
        ["ffmpeg", "-y", "-v", "quiet", "-i", path, "-ar", str(SR), "-ac", "1", out_path],
        check=True,
    )
    return out_path


def extract_f0(wav: np.ndarray, fmin: float = 80.0, fmax: float = 600.0) -> np.ndarray:
    """Autocorrelation f0 per hop → ``[1 + len(wav) // 160]`` Hz (0 =
    unvoiced)."""
    n_frames = 1 + len(wav) // HOP
    f0 = np.zeros(n_frames, np.float32)
    lo = int(SR / fmax)
    hi = min(int(SR / fmin), WIN - 1)
    pad = np.pad(wav, (WIN // 2, WIN // 2))
    for i in range(n_frames):
        seg = pad[i * HOP : i * HOP + WIN]
        seg = seg - seg.mean()
        if float(np.dot(seg, seg)) < 1e-4:
            continue
        ac = np.correlate(seg, seg, "full")[WIN - 1 :]
        ac = ac / (ac[0] + 1e-9)
        peak = int(np.argmax(ac[lo:hi])) + lo
        if ac[peak] > 0.3:
            f0[i] = SR / peak
    return f0


def hubert_checkpoint() -> str:
    """The converted HuBERT checkpoint's path, or ``""`` when absent."""
    path = os.environ.get("GF_HUBERT_CKPT", "data/ckpt/hubert.pkl")
    return path if os.path.exists(path) else ""


def load_hubert(path: str, device) -> torch.nn.Module:
    """The encoder of a converted checkpoint, in eval mode on ``device``
    (built on the ``meta`` device and given the checkpoint's arrays: no
    random initialization of ~316M parameters, no second copy)."""
    from geneface_tpu_torch.convert import load_flax_variables
    from geneface_tpu_torch.datagen.wav2vec2 import Wav2Vec2CTC, load_wav2vec2_params

    cfg, variables = load_wav2vec2_params(path)
    with torch.device("meta"):
        model = Wav2Vec2CTC(cfg)
    load_flax_variables(model, variables, assign=True)
    return model.to(device).eval()


@torch.inference_mode()
def extract_hubert(wav: np.ndarray, device=None, model: torch.nn.Module | None = None):
    """``[S]`` waveform → HuBERT hidden states ``[2T, 1024]`` float32 (stride
    320, each row repeated twice: 100 rows per second, as the reference's
    binarizer), or ``None`` without a checkpoint. The waveform is
    normalized to zero mean and unit variance first. ``model`` (from
    :func:`load_hubert`) skips reading the checkpoint; ``device`` defaults
    to the card."""
    from geneface_tpu_torch import resolve_device
    from geneface_tpu_torch.datagen.wav2vec2 import normalize_waveform

    if model is None:
        ckpt = hubert_checkpoint()
        if not ckpt:
            return None
        model = load_hubert(ckpt, resolve_device(device))
    dev = next(model.parameters()).device
    w = torch.from_numpy(normalize_waveform(wav)).to(dev)[None]
    with torch.profiler.record_function("gf::hubert"):
        hidden = model(w)[0]
    hidden = hidden.float().cpu().numpy()
    return np.repeat(hidden, 2, axis=0).astype(np.float32)
