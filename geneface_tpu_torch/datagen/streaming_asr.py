"""Streaming ASR for live-driven talking heads (port of
``geneface_tpu/datagen/streaming_asr.py``).

The reference's live-microphone ASR class (``data_util/extract_esperanto.py:
35-380``): 20 ms chunks stream through a sliding segment of ``stride_left +
context + stride_right`` chunks; each :meth:`StreamingASR.run_step` that
completes a segment forwards it through the converted esperanto wav2vec2,
keeps the middle logits (the strides absorb the boundary effects) and writes
them to a ring buffer, from which :meth:`~StreamingASR.get_next_feat`
serves the ``[8, C, 16]`` attention windows of one video frame.

Sources: a wav path, a numpy waveform, any iterator of 320-sample chunks,
or ``"live"`` (the microphone, pyaudio imported when the stream starts).
Each segment is normalized on its own, ``(seg - mean) / sqrt(var +
1e-7)`` in numpy as the JAX code writes it, then runs eagerly on the port's
:class:`~geneface_tpu_torch.datagen.wav2vec2.Wav2Vec2CTC` (the card unless
``device="cpu"``). There is no ``transformers`` fallback: without a
converted checkpoint the constructor raises ``RuntimeError``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

__all__ = ["StreamingASR", "CHUNK"]

SR = 16000
CHUNK = SR // 50  # 320 samples = 20 ms


class StreamingASR:
    """Chunked streaming wav2vec2 features (reference ``ASR`` class).

    ``source``: wav path | np.ndarray waveform | iterator of [320] chunks |
    ``"live"`` (microphone via pyaudio). Latency ≈
    ``(context + stride_right) * 20 ms``. ``model`` (from
    ``asr_features.load_esperanto``) skips reading ``flax_ckpt``.
    """

    def __init__(
        self,
        source,
        flax_ckpt: str | None = None,
        context_size: int = 12,
        stride_left: int = 4,
        stride_right: int = 4,
        audio_dim: int = 44,
        vocab: list[str] | None = None,
        save_feats: bool = False,
        device=None,
        model: torch.nn.Module | None = None,
    ):
        self.context_size = context_size
        self.stride_left = stride_left
        self.stride_right = stride_right
        self.audio_dim = audio_dim
        self.vocab = vocab
        self.save_feats = save_feats
        self.terminated = False
        self.text = "[START]"
        self.all_logits: list[np.ndarray] = []

        # left-pad like the reference (zeros for the first segment's stride)
        self.frames: list[np.ndarray] = [
            np.zeros(CHUNK, np.float32)
        ] * stride_left

        self._iter = self._make_source(source)
        if model is None:
            from geneface_tpu_torch.datagen.asr_features import load_esperanto

            model = load_esperanto(flax_ckpt, device)
        self.model = model

        # ring feature buffer + attention-window state
        # (reference feat_queue/front/tail/att_feats, ``:99-112``)
        self.feat_buffer_size = 4
        self.feat_buffer_idx = 0
        self.feat_queue = np.zeros(
            (self.feat_buffer_size * context_size, audio_dim), np.float32
        )
        self.front = self.feat_buffer_size * context_size - 8
        self.tail = 8
        self.att_feats = [np.zeros((audio_dim, 16), np.float32)] * 4

    # ------------------------------------------------------------ source ----
    def _make_source(self, source):
        if isinstance(source, str) and source == "live":
            return self._mic_chunks()
        if isinstance(source, str):  # wav path
            from geneface_tpu_torch.utils.audio import load_wav16k

            wav = np.asarray(load_wav16k(source), np.float32)
            return self._array_chunks(wav)
        if isinstance(source, np.ndarray):
            return self._array_chunks(source.astype(np.float32))
        return iter(source)  # any iterator of [320] chunks

    @staticmethod
    def _array_chunks(wav):
        for i in range(0, len(wav) - CHUNK + 1, CHUNK):
            yield wav[i : i + CHUNK]

    def _mic_chunks(self):  # pragma: no cover - needs audio hardware
        try:
            import pyaudio
        except ImportError as e:
            raise ImportError(
                "live streaming needs pyaudio; pass a wav path / array / chunk "
                "iterator instead"
            ) from e
        audio = pyaudio.PyAudio()
        stream = audio.open(
            format=pyaudio.paInt16, channels=1, rate=SR, input=True,
            frames_per_buffer=CHUNK,
        )
        while not self.terminated:
            buf = stream.read(CHUNK, exception_on_overflow=False)
            yield np.frombuffer(buf, np.int16).astype(np.float32) / 32768.0
        stream.stop_stream()
        stream.close()

    # ----------------------------------------------------------- forward ----
    @torch.inference_mode()
    def _forward(self, seg: np.ndarray) -> np.ndarray:
        """One segment ``[S]`` → CTC logits ``[S // 320 - 1, vocab]``."""
        seg = (seg - seg.mean()) / np.sqrt(seg.var() + 1e-7)
        dev = next(self.model.parameters()).device
        with record_function("gf::streaming_asr"):
            x = torch.from_numpy(np.asarray(seg, np.float32)).to(dev)[None]
            return self.model(x)[0].float().cpu().numpy()

    # -------------------------------------------------------------- step ----
    def run_step(self) -> bool:
        """Consume one 20 ms chunk; forward a segment when enough context
        accumulated. Returns False once the stream is exhausted and the
        final segment has been flushed (reference ``run_step``)."""
        if self.terminated:
            return False
        frame = next(self._iter, None)
        if frame is None:
            self.terminated = True
        else:
            self.frames.append(np.asarray(frame, np.float32))
            need = self.stride_left + self.context_size + self.stride_right
            if len(self.frames) < need:
                return True

        seg = np.concatenate(self.frames)
        if not self.terminated:
            self.frames = self.frames[-(self.stride_left + self.stride_right):]

        logits = self._forward(seg)[:, : self.audio_dim]  # [N-1, C]
        left = max(0, self.stride_left)
        right = logits.shape[0] - self.stride_right + 1
        if self.terminated:
            right = logits.shape[0]
        feats = logits[left:right]

        if self.save_feats:
            self.all_logits.append(feats)
        # ring write (constant memory, reference ``:216-221``)
        start = self.feat_buffer_idx * self.context_size
        end = min(start + feats.shape[0], self.feat_queue.shape[0])
        self.feat_queue[start:end] = feats[: end - start]
        self.feat_buffer_idx = (self.feat_buffer_idx + 1) % self.feat_buffer_size

        if self.vocab is not None:
            ids = feats.argmax(-1)
            # CTC greedy: collapse repeats, drop blanks (last vocab slot)
            out, prev = [], -1
            for t in ids:
                if t != prev and t < len(self.vocab) - 1:
                    out.append(self.vocab[t])
                prev = t
            if out:
                self.text += " " + "".join(out)
        return not self.terminated

    def get_next_feat(self) -> np.ndarray:
        """→ [8, C, 16] attention window stack for one video frame
        (reference ``get_next_feat``: stride-2 ring reads)."""
        Q = self.feat_queue.shape[0]
        while len(self.att_feats) < 8:
            if self.front < self.tail:
                feat = self.feat_queue[self.front : self.tail]
            else:
                feat = np.concatenate(
                    [self.feat_queue[self.front :], self.feat_queue[: self.tail]]
                )
            self.front = (self.front + 2) % Q
            self.tail = (self.tail + 2) % Q
            self.att_feats.append(feat.T)  # [C, 16]
        out = np.stack(self.att_feats)  # [8, C, 16]
        self.att_feats = self.att_feats[1:]
        return out

    def run(self, out_npy: str | None = None) -> np.ndarray | None:
        """Drain the source; with ``save_feats``, return (and optionally
        save) the ``[T25, 16, C]`` training windows — identical layout to
        ``extract_esperanto_features`` (reference ``:230-250`` unfold)."""
        while self.run_step():
            pass
        if not self.save_feats:
            return None
        from geneface_tpu_torch.datagen.asr_features import logits_to_windows

        logits = (
            np.concatenate(self.all_logits)
            if self.all_logits
            else np.zeros((0, self.audio_dim), np.float32)
        )
        wins = logits_to_windows(logits)
        if out_npy:
            np.save(out_npy, wins)
        return wins
