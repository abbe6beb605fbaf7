"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface under ``csrc/build/`` (git-ignored) at first use, and is
rebuilt when the source is newer than the library; ``ctypes`` loads it.
Nothing here runs at import time, and nothing falls back: a missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

__all__ = ["CSRC_DIR", "BUILD_DIR", "build_kernel", "load_kernel"]

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "build")

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the GPU host")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def build_command(name: str) -> list[str]:
    """The nvcc command that builds ``csrc/<name>.cu``."""
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", library_path(name) + ".part", os.path.join(CSRC_DIR, f"{name}.cu"),
    ]


def build_kernel(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.
    Returns nvcc's output (register and shared-memory use per kernel)."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    lib = library_path(name)
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    proc = subprocess.run(build_command(name), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(lib + ".part", lib)
    return proc.stdout + proc.stderr


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        if name not in _LOADED:
            build_kernel(name)
            _LOADED[name] = ctypes.CDLL(library_path(name))
        return _LOADED[name]
