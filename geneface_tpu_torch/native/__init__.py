"""ctypes bindings of the native (C++) host library (port of
``geneface_tpu/native``; source ``csrc/gf_native.cpp``).

- :class:`NativeBatchLoader`: the threaded pixel-batch assembler (gather of
  the gt and background pixels of the sampled rays and the fixed-point
  torso-over-background composite, uint8), behind
  :class:`~geneface_tpu_torch.data.radnerf_dataset.RADNeRFDataset`'s
  default ``native_loader``;
- :class:`NativeStore`: mmap'd byte-range reads of the IndexedDataset chunk
  files, behind :class:`~geneface_tpu_torch.utils.indexed_dataset.
  IndexedDataset`'s default ``use_native``.

Nothing is built at import. :func:`load_library` builds the library with
``g++`` on first use (:mod:`.build`) and raises when that fails: unlike
the JAX package, nothing falls back to numpy behind the caller's back
(``native_loader: false`` / ``use_native=False`` choose the Python paths).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

__all__ = ["NativeBatchLoader", "NativeStore", "load_library"]

_LOCK = threading.Lock()
_LIB: list = []  # the loaded library, once


def load_library() -> ctypes.CDLL:
    """The loaded library, built first if needed (raises on failure)."""
    with _LOCK:
        if _LIB:
            return _LIB[0]
        from geneface_tpu_torch.native.build import build

        lib = ctypes.CDLL(build())
        c_u8p = ctypes.POINTER(ctypes.c_uint8)
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        c_i64p = ctypes.POINTER(ctypes.c_int64)
        lib.gf_loader_create.restype = ctypes.c_void_p
        lib.gf_loader_create.argtypes = [
            c_u8p, c_u8p, ctypes.c_int, c_u8p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ]
        lib.gf_loader_destroy.restype = None
        lib.gf_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.gf_loader_submit.restype = None
        lib.gf_loader_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.gf_loader_wait.restype = ctypes.c_int64
        lib.gf_loader_wait.argtypes = [ctypes.c_void_p, c_i32p, c_u8p, c_u8p, c_u8p]
        lib.gf_gather.restype = None
        lib.gf_gather.argtypes = [
            c_u8p, c_u8p, ctypes.c_int, c_u8p, ctypes.c_int64, ctypes.c_int64,
            c_i32p, ctypes.c_int64, c_u8p, c_u8p, c_u8p,
        ]
        lib.gf_store_open.restype = ctypes.c_void_p
        lib.gf_store_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, c_i64p]
        lib.gf_store_close.restype = None
        lib.gf_store_close.argtypes = [ctypes.c_void_p]
        lib.gf_store_read.restype = ctypes.c_int
        lib.gf_store_read.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, c_u8p]
        lib.gf_store_prefetch.restype = None
        lib.gf_store_prefetch.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        _LIB.append(lib)
        return lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeBatchLoader:
    """Threaded prefetching gather of (inds, gt, bg, bg_torso) ray batches
    over uint8 frame planes that this object keeps alive:

    - ``gt``    [T, HW, 3] uint8
    - ``torso`` [T, HW, 4] uint8 (straight alpha) or [T, HW, 3]
    - ``bg``    [HW, 3] uint8

    :meth:`submit` queues a job (uniform random pixels, or a row-major rect
    for a lip patch); :meth:`wait` returns the oldest job's batch, in submit
    order. :meth:`gather` gathers caller-given indices synchronously."""

    _h = None

    def __init__(self, gt, torso, bg, n_threads: int = 2, depth: int = 4):
        self._lib = load_library()
        self.gt = np.ascontiguousarray(gt, np.uint8)
        self.torso = np.ascontiguousarray(torso, np.uint8)
        self.bg = np.ascontiguousarray(bg, np.uint8)
        if self.gt.ndim != 3 or self.gt.shape[-1] != 3:
            raise ValueError(f"gt must be [T, HW, 3] uint8, got {self.gt.shape}")
        if self.torso.ndim != 3 or self.torso.shape[-1] not in (3, 4):
            raise ValueError(f"torso must be [T, HW, 3|4] uint8, got {self.torso.shape}")
        if self.bg.ndim != 2 or self.bg.shape[-1] != 3:
            raise ValueError(f"bg must be [HW, 3] uint8, got {self.bg.shape}")
        self.T, self.HW = self.gt.shape[0], self.gt.shape[1]
        if self.torso.shape[:2] != (self.T, self.HW) or self.bg.shape[0] != self.HW:
            raise ValueError("gt, torso and bg disagree on frames or pixels")
        self._h = self._lib.gf_loader_create(
            _u8p(self.gt), _u8p(self.torso), self.torso.shape[-1],
            _u8p(self.bg), self.T, self.HW, n_threads, depth,
        )
        self._pending = []  # rays per job in flight

    def submit(self, frame: int, n_rays: int, seed: int, rect=None, W: int = 0) -> None:
        """``rect = (x0, y0, h, w)``: that grid, row-major, in a frame ``W``
        wide; otherwise ``n_rays`` uniform random pixels."""
        if not 0 <= frame < self.T:
            raise IndexError(f"frame {frame} out of range [0, {self.T})")
        if rect is not None:
            x0, y0, h, w = [int(v) for v in rect]
            n = h * w
            self._lib.gf_loader_submit(self._h, frame, n, seed, x0, y0, h, w, W)
        else:
            n = int(n_rays)
            self._lib.gf_loader_submit(self._h, frame, n, seed, 0, 0, 0, 0, 0)
        self._pending.append(n)

    def wait(self) -> tuple:
        """→ (inds [n] int32, gt, bg, bg_torso [n, 3] uint8) of the oldest job."""
        n = self._pending.pop(0)
        inds = np.empty((n,), np.int32)
        gt, bg, bgt = (np.empty((n, 3), np.uint8) for _ in range(3))
        got = self._lib.gf_loader_wait(self._h, _i32p(inds), _u8p(gt), _u8p(bg), _u8p(bgt))
        if got != n:
            raise RuntimeError(f"native loader returned {got} rays for a job of {n}")
        return inds, gt, bg, bgt

    def gather(self, frame: int, inds: np.ndarray) -> tuple:
        """→ (gt, bg, bg_torso [n, 3] uint8) of frame ``frame`` at pixel
        indices ``inds``: the gathered pixels and the torso composited
        over the background in fixed point."""
        if not 0 <= frame < self.T:
            raise IndexError(f"frame {frame} out of range [0, {self.T})")
        inds = np.ascontiguousarray(inds, np.int32)
        if inds.size and (inds.min() < 0 or inds.max() >= self.HW):
            raise IndexError(f"pixel index out of range [0, {self.HW})")
        n = inds.shape[0]
        gt, bg, bgt = (np.empty((n, 3), np.uint8) for _ in range(3))
        self._lib.gf_gather(
            _u8p(self.gt[frame]), _u8p(self.torso[frame]), self.torso.shape[-1],
            _u8p(self.bg), self.HW, 0, _i32p(inds), n, _u8p(gt), _u8p(bg), _u8p(bgt),
        )
        return gt, bg, bgt

    def close(self) -> None:
        if self._h:
            self._lib.gf_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


class NativeStore:
    """mmap'd byte-range reads over IndexedDataset chunk files."""

    _h = None

    def __init__(self, chunk_paths: list[str], chunk_begin: list[int]):
        self._lib = load_library()
        arr = (ctypes.c_char_p * len(chunk_paths))(*[p.encode() for p in chunk_paths])
        begins = np.asarray(chunk_begin, np.int64)
        self._h = self._lib.gf_store_open(
            arr, len(chunk_paths), begins.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if not self._h:
            raise OSError(f"gf_store_open failed for {chunk_paths}")

    def read(self, abs_off: int, length: int) -> bytes:
        out = np.empty((length,), np.uint8)
        if self._lib.gf_store_read(self._h, abs_off, length, _u8p(out)) != 0:
            raise OSError(f"gf_store_read({abs_off}, {length}) failed")
        return out.tobytes()

    def prefetch(self, abs_off: int, length: int) -> None:
        self._lib.gf_store_prefetch(self._h, abs_off, length)

    def close(self) -> None:
        if self._h:
            self._lib.gf_store_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
