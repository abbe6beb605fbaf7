"""DeepSpeech input prep: MFCC and context windows (a copy of
``geneface_tpu/datagen/_ds_audio.py``, numpy, bit for bit the same rows).

``python_speech_features.mfcc(signal, 16000, numcep=26)`` at the package's
defaults (25 ms frames, 10 ms hop, rectangular window, 0.97 preemphasis, 26
mel filters, 512-point FFT, orthonormal DCT-II, lifter 22, c0 replaced by
the log frame energy), re-derived formula by formula; then every second
frame (20 ms steps), ±9 context frames stacked into ``[T, 494]`` rows and
the whole utterance normalized to zero mean and unit std
(``data_util/deepspeech_features/deepspeech_features.py:191-249`` of the
reference).
"""

from __future__ import annotations

import numpy as np

__all__ = ["mfcc", "audio_to_mfcc_windows"]

SR = 16000


def _dct2_ortho(x: np.ndarray, n_out: int) -> np.ndarray:
    """Orthonormal DCT-II over the last axis (scipy-free)."""
    N = x.shape[-1]
    k = np.arange(n_out)[:, None]
    n = np.arange(N)[None, :]
    basis = np.cos(np.pi * k * (2 * n + 1) / (2 * N))  # [n_out, N]
    scale = np.sqrt(2.0 / N) * np.ones((n_out, 1))
    scale[0] *= np.sqrt(0.5)
    return x @ (basis * scale).T


def _mel_fbank(n_fft: int, n_filt: int, sr: int = SR) -> np.ndarray:
    """python_speech_features.get_filterbanks (low=0, high=sr/2)."""

    def hz2mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel2hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    pts = np.linspace(hz2mel(0.0), hz2mel(sr / 2.0), n_filt + 2)
    bins = np.floor((n_fft + 1) * mel2hz(pts) / sr).astype(int)
    fb = np.zeros((n_filt, n_fft // 2 + 1))
    for m in range(1, n_filt + 1):
        lo, c, hi = bins[m - 1], bins[m], bins[m + 1]
        for k in range(lo, c):
            fb[m - 1, k] = (k - lo) / (c - lo)
        for k in range(c, hi):
            fb[m - 1, k] = (hi - k) / (hi - c)
    return fb


def mfcc(
    audio: np.ndarray,  # int16-range or [-1, 1] float mono @16k
    num_cepstrum: int = 26,
    win_s: float = 0.025,
    hop_s: float = 0.01,
    n_filt: int = 26,
    n_fft: int = 512,
    preemph: float = 0.97,
    ceplifter: int = 22,
    append_energy: bool = True,
) -> np.ndarray:
    """[T, num_cepstrum] MFCCs, python_speech_features-exact (pkg defaults)."""
    a = np.asarray(audio, np.float64)
    if a.dtype.kind == "f" and np.abs(a).max() <= 1.5:
        a = a * 32767.0  # reference feeds int16 wav data
    # preemphasis (sigproc.preemphasis)
    a = np.append(a[0], a[1:] - preemph * a[:-1])
    win = int(round(SR * win_s))
    hop = int(round(SR * hop_s))
    # sigproc.framesig: ceil frame count + zero pad
    slen = len(a)
    T = 1 if slen <= win else 1 + int(np.ceil((slen - win) / hop))
    padded = np.concatenate([a, np.zeros(((T - 1) * hop + win) - slen)])
    idx = np.arange(win)[None, :] + hop * np.arange(T)[:, None]
    frames = padded[idx]  # rectangular window (psf default winfunc)
    pspec = np.abs(np.fft.rfft(frames, n_fft)) ** 2 / n_fft
    energy = np.maximum(pspec.sum(axis=1), np.finfo(np.float64).eps)
    mel = np.maximum(
        pspec @ _mel_fbank(n_fft, n_filt).T, np.finfo(np.float64).eps
    )
    feat = _dct2_ortho(np.log(mel), num_cepstrum)
    if ceplifter > 0:
        n = np.arange(num_cepstrum)
        feat = feat * (1.0 + (ceplifter / 2.0) * np.sin(np.pi * n / ceplifter))
    if append_energy:
        feat[:, 0] = np.log(energy)
    return feat.astype(np.float32)


def audio_to_mfcc_windows(
    audio: np.ndarray, num_cepstrum: int = 26, num_context: int = 9
) -> tuple[np.ndarray, int]:
    """→ ([T, (2*ctx+1)*n_cep] context-stacked input, T)
    (``deepspeech_features.py:216-249``)."""
    feats = mfcc(audio, num_cepstrum)
    feats = feats[::2]  # BiRNN stride = 2 -> one row per 20 ms
    T = feats.shape[0]
    pad = np.zeros((num_context, num_cepstrum), np.float32)
    padded = np.concatenate([pad, feats, pad], 0)
    rows = np.stack(
        [padded[t : t + 2 * num_context + 1].reshape(-1) for t in range(T)]
    )
    # DeepSpeech normalizes the full utterance input
    rows = (rows - rows.mean()) / max(rows.std(), 1e-8)
    return rows.astype(np.float32), T
