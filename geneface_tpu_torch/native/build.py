"""Build the native host library (``csrc/gf_native.cpp`` → ``csrc/build/
libgf_native.so``) with ``g++``.

Run directly (``python -m geneface_tpu_torch.native.build``) or let
:func:`geneface_tpu_torch.native.load_library` build it on first use. The
library is one translation unit with a plain C interface, built with the
JAX package's flags. Each process compiles to its own ``.part`` file and
renames it into place, so processes that build at once do not race. A
missing ``g++`` or a failed build raises.
"""

from __future__ import annotations

import os
import shutil
import subprocess

from geneface_tpu_torch.kernels import BUILD_DIR, CSRC_DIR

__all__ = ["SRC", "LIB", "build_command", "build"]

SRC = os.path.join(CSRC_DIR, "gf_native.cpp")
LIB = os.path.join(BUILD_DIR, "libgf_native.so")


def build_command(src: str = SRC, out: str = LIB) -> list[str]:
    """The ``g++`` command that builds ``src`` into ``out``."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native host library is built with g++")
    return [gxx, "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-Wall", src, "-o", out]


def build(src: str = SRC, lib: str = LIB) -> str:
    """Compile ``src`` unless ``lib`` is newer; returns the library's path."""
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return lib
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    part = f"{lib}.{os.getpid()}.part"
    try:
        res = subprocess.run(build_command(src, part), capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"gf_native build failed:\n{res.stderr[-4000:]}")
        os.replace(part, lib)
    finally:
        if os.path.exists(part):
            os.remove(part)
    return lib


if __name__ == "__main__":
    print(build())
