"""A video frame's renderer inputs from its pose — the wrapper of the CUDA
kernel ``csrc/frame_inputs.cu`` and its plain version.

:func:`frame_inputs` gives the full frame's rays (``rays_o``/``rays_d``
``[H*W, 3]`` float32, :func:`~geneface_tpu_torch.utils.camera.get_rays`)
and, given the frame's torso plane, the head's background: the torso over
the video's background as the dataset composites it
(:func:`~geneface_tpu_torch.data.radnerf_dataset.composite_torso`,
``[H*W, 3]`` float32). On the card one launch builds them from the pose,
the intrinsics, the plane (copied as the dataset holds it: 1 MB for a 512²
uint8 RGBA plane) and the background the caller keeps there; the CPU runs
:func:`frame_inputs_plain`, the host path in numpy. The two agree bit for
bit (the kernel repeats numpy's float32 operations in numpy's order).

A CPU device runs the plain version; a CUDA device launches the kernel or
raises. ``LAUNCHES["frame_inputs"]`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from geneface_tpu_torch.data.radnerf_dataset import composite_torso
from geneface_tpu_torch.kernels import LAUNCHES
from geneface_tpu_torch.utils.camera import get_rays

__all__ = ["frame_inputs", "frame_inputs_plain", "launch_frame_inputs"]

_PLANE_CODES = {np.dtype(np.uint8): 1, np.dtype(np.float32): 2}
_PLANE_CODES_T = {torch.uint8: 1, torch.float32: 2}
_FN = None  # the bound kernel, set at first launch


def _check(H: int, W: int, torso_img, bg) -> None:
    """What the kernel takes, checked on every device, so that the CPU
    tests refuse what the card would."""
    if H <= 0 or W <= 0 or H * W >= 2**31:
        raise ValueError(f"frame {H}x{W} must have 1 to 2^31 - 1 pixels")
    if torso_img is None:
        return
    shape = np.shape(torso_img)
    if len(shape) != 3 or shape[:2] != (H, W) or shape[2] not in (3, 4):
        raise ValueError(f"torso plane must be [{H}, {W}, 3|4], got {shape}")
    if bg is None or tuple(bg.shape) != (H * W, 3) or bg.dtype != torch.float32:
        raise ValueError(f"background must be float32 [{H * W}, 3], got "
                         f"{None if bg is None else (bg.dtype, tuple(bg.shape))}")


def frame_inputs_plain(pose, intrinsics, H: int, W: int, torso_img=None,
                       bg: torch.Tensor | None = None) -> tuple:
    """The host path: :func:`get_rays` and :func:`composite_torso` in numpy
    (``bg`` a CPU tensor) → (rays_o, rays_d, bg_torso | None) CPU tensors."""
    rays = get_rays(pose, intrinsics, H, W)
    rays_o = torch.from_numpy(rays["rays_o"].astype(np.float32))
    rays_d = torch.from_numpy(rays["rays_d"].astype(np.float32))
    if torso_img is None:
        return rays_o, rays_d, None
    torso = composite_torso(torso_img, bg.numpy().reshape(H, W, 3))
    return rays_o, rays_d, torch.from_numpy(torso.reshape(-1, 3).astype(np.float32))


def frame_inputs(pose, intrinsics, H: int, W: int, device, torso_img=None,
                 bg: torch.Tensor | None = None) -> tuple:
    """The ``H``×``W`` frame's inputs on ``device``: ``pose`` the c2w
    ``[4, 4]`` (or its first three rows), ``intrinsics`` (fx, fy, cx, cy);
    with ``torso_img`` (the sample's plane ``[H, W, 3|4]``, uint8 or float,
    scaled by 1/255 where its largest value is above 1.5) also its
    composite over ``bg`` (the video's background, float32 ``[H*W, 3]`` on
    ``device``) → (rays_o, rays_d, bg_torso | None). On the card the plane
    is copied as it is held (other dtypes as float32) and
    :func:`launch_frame_inputs` runs."""
    device = torch.device(device)
    _check(H, W, torso_img, bg)
    if device.type == "cpu":
        return frame_inputs_plain(pose, intrinsics, H, W, torso_img, bg)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    plane, scale = None, False
    if torso_img is not None:
        host = np.asarray(torso_img)
        if host.dtype not in _PLANE_CODES:
            host = host.astype(np.float32)
        scale = bool(host.max() > 1.5)
        plane = torch.from_numpy(np.ascontiguousarray(host)).to(device)
    return launch_frame_inputs(pose, intrinsics, H, W, device, plane, scale, bg)


def _kernel():
    """``gf_frame_inputs`` of the built library, its argument types set once."""
    global _FN
    if _FN is None:
        from geneface_tpu_torch.kernels import load_kernel

        fn = load_kernel("frame_inputs").gf_frame_inputs
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def launch_frame_inputs(pose, intrinsics, H: int, W: int, device, plane=None,
                        scale: bool = False, bg: torch.Tensor | None = None) -> tuple:
    """The kernel on the CUDA ``device``: ``plane`` the torso plane already
    there (contiguous ``[H, W, 3|4]`` uint8 or float32) or None for the rays
    alone, ``scale`` whether to divide it by 255, ``bg`` as for
    :func:`frame_inputs` → (rays_o, rays_d, bg_torso | None)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if plane is not None:
        _check(H, W, plane, bg)
        pixel = 4 * plane.element_size() if plane.shape[-1] == 4 else 1
        if (plane.device != device or plane.dtype not in _PLANE_CODES_T
                or not plane.is_contiguous() or plane.data_ptr() % pixel):
            raise ValueError(f"plane must be a contiguous uint8 or float32 tensor on {device}, "
                             "a 4-channel one aligned to its pixel")
        if bg.device != device or not bg.is_contiguous() or bg.data_ptr() % 16:
            raise ValueError(f"background must be contiguous and 16-byte aligned on {device}")
    fn = _kernel()
    rows = np.ascontiguousarray(np.asarray(pose, np.float32)[:3, :4]).reshape(-1)
    fx, fy, cx, cy = (float(v) for v in intrinsics)
    rays_o = torch.empty(H * W, 3, dtype=torch.float32, device=device)
    rays_d = torch.empty_like(rays_o)
    out = None if plane is None else torch.empty_like(rays_o)
    code = 0 if plane is None else _PLANE_CODES_T[plane.dtype]
    channels = 0 if plane is None else plane.shape[-1]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), fx, fy, cx, cy, H, W,
            None if plane is None else plane.data_ptr(), code, channels, int(scale),
            None if out is None else bg.data_ptr(), rays_o.data_ptr(), rays_d.data_ptr(),
            None if out is None else out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"frame_inputs kernel launch failed: cudaError {rc}")
    LAUNCHES["frame_inputs"] += 1
    return rays_o, rays_d, out
