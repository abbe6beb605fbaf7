"""Scalar metrics as JSON lines, images as files, and both as TensorBoard
event files (port of ``geneface_tpu/utils/logging.py``): one ``{"step",
"ts", <prefix><name>...}`` object per call, appended to
``<work_dir>/metrics.jsonl``; an image to
``<work_dir>/images/<tag>/step_<n>.png`` (``.npy`` without PIL).

The JAX logger also writes ``<work_dir>/tb/`` through
``torch.utils.tensorboard.SummaryWriter`` when that imports. The port
writes the same records with its own encoder (:class:`EventFileWriter`),
so it needs neither ``tensorboard`` nor ``tensorflow``: the TFRecord
framing (a little-endian length, the masked CRC-32C of the length, the
payload, the masked CRC-32C of the payload) around ``Event`` protobufs
written field by field — the file-version event first, then one event per
scalar (``Summary.Value.simple_value``, a float32) and per image
(``Summary.Image``, PNG-encoded with :mod:`zlib`).
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
import zlib

import numpy as np

__all__ = ["MetricsLogger", "EventFileWriter", "encode_png"]


def _crc32c_table() -> list:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def masked_crc32c(data: bytes) -> int:
    """The TFRecord checksum: CRC-32C (Castagnoli) of ``data``, rotated
    right by 15 bits plus ``0xa282ead8`` (mod 2³²)."""
    crc = 0xFFFFFFFF
    table = _CRC32C
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    crc ^= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # negative int64s take ten bytes, as protobuf writes them
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _event(wall_time: float, step: int = 0, body: bytes = b"") -> bytes:
    """``Event{wall_time = 1, step = 2, <body>}`` (proto3: a zero step is
    left out)."""
    out = _key(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += _key(2, 0) + _varint(int(step))
    return out + body


def _summary(tag: str, value: bytes) -> bytes:
    """``Event.summary = 5`` holding one ``Summary.Value{tag = 1, <value>}``."""
    return _bytes_field(5, _bytes_field(1, _bytes_field(1, tag.encode()) + value))


def encode_png(arr: np.ndarray) -> bytes:
    """``[H, W]`` or ``[H, W, C]`` uint8 (C = 1, 3 or 4) → PNG bytes
    (8-bit, no filter, one zlib stream)."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    color = {1: 0, 3: 2, 4: 6}[c]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


class EventFileWriter:
    """One TensorBoard event file,
    ``<log_dir>/events.out.tfevents.<time>.<host>.<pid>.<n>`` as
    TensorBoard's own writer names it, opened with the file-version event;
    each record is written and flushed at once."""

    _count = 0

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "events.out.tfevents.%010d.%s.%s.%s" % (
            time.time(), socket.gethostname(), os.getpid(), EventFileWriter._count))
        EventFileWriter._count += 1
        self._f = open(self.path, "wb")
        writer = _bytes_field(1, b"tensorboard.summary.writer.event_file_writer")
        self._write(_event(time.time(), body=_bytes_field(3, b"brain.Event:2")
                           + _bytes_field(10, writer)))

    def _write(self, event: bytes) -> None:
        header = struct.pack("<Q", len(event))
        self._f.write(header + struct.pack("<I", masked_crc32c(header)) + event
                      + struct.pack("<I", masked_crc32c(event)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(time.time(), step,
                           _summary(tag, _key(2, 5) + struct.pack("<f", value))))

    def add_image(self, tag: str, img: np.ndarray, step: int) -> None:
        """``img``: ``[H, W, C]`` uint8."""
        h, w, c = img.shape
        image = (_key(1, 0) + _varint(h) + _key(2, 0) + _varint(w) + _key(3, 0) + _varint(c)
                 + _bytes_field(4, encode_png(img)))
        self._write(_event(time.time(), step, _summary(tag, _bytes_field(4, image))))

    def close(self) -> None:
        self._f.close()


class MetricsLogger:
    """``use_tensorboard``: also write the scalars and images to
    ``<work_dir>/tb/`` (the JAX logger's default)."""

    def __init__(self, work_dir: str, use_tensorboard: bool = True):
        self.work_dir = work_dir
        os.makedirs(work_dir, exist_ok=True)
        self.jsonl_path = os.path.join(work_dir, "metrics.jsonl")
        self._tb = EventFileWriter(os.path.join(work_dir, "tb")) if use_tensorboard else None

    def log_scalars(self, scalars: dict, step: int, prefix: str = "") -> None:
        clean = {}
        for k, v in scalars.items():
            try:
                clean[f"{prefix}{k}"] = float(v)
            except (TypeError, ValueError, RuntimeError):
                continue
        if self._tb is not None:
            for k, v in clean.items():
                self._tb.add_scalar(k, v, step)
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps({"step": step, "ts": time.time(), **clean}) + "\n")

    def log_image(self, tag: str, img, step: int) -> str:
        """``img``: HWC uint8, or float in [0, 1] (a tensor or an array) →
        the path written, ``images/<tag with '/' as '_'>/step_<step>.png``,
        or ``.npy`` when PIL is missing; also to ``tb/``."""
        arr = np.asarray(img.detach().cpu() if hasattr(img, "detach") else img)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        if self._tb is not None:
            self._tb.add_image(tag, arr, step)
        img_dir = os.path.join(self.work_dir, "images", tag.replace("/", "_"))
        os.makedirs(img_dir, exist_ok=True)
        try:
            from PIL import Image
        except ImportError:
            path = os.path.join(img_dir, f"step_{step}.npy")
            np.save(path, arr)
            return path
        path = os.path.join(img_dir, f"step_{step}.png")
        Image.fromarray(arr).save(path)
        return path

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
