"""RAD-NeRF per-video frame store, inference side (port of
``geneface_tpu/data/radnerf_dataset.py`` with ``training=False``).

Reads the binarizer's ``trainval_dataset.npy``, converts poses to the ngp
convention, optionally smooths the camera path, and serves full-frame rays
plus the background the head is composited over. Training-time ray sampling
and the native batch loader are not part of the inference port.
"""

from __future__ import annotations

import os

import numpy as np

from geneface_tpu_torch.utils.camera import (
    convert_poses,
    get_bg_coords,
    get_rays,
    nerf_matrix_to_ngp,
)

__all__ = ["RADNeRFDataset", "smooth_camera_path", "get_cond_window"]


def smooth_camera_path(poses: np.ndarray, kernel_size: int = 7) -> np.ndarray:
    """Sliding-window mean of translations and rotations (rotation mean via
    scipy's quaternion mean)."""
    from scipy.spatial.transform import Rotation

    poses = poses.copy()
    N = poses.shape[0]
    K = kernel_size // 2
    trans = poses[:, :3, 3].copy()
    rots = poses[:, :3, :3].copy()
    for i in range(N):
        lo, hi = max(0, i - K), min(N, i + K + 1)
        poses[i, :3, 3] = trans[lo:hi].mean(0)
        try:
            poses[i, :3, :3] = Rotation.from_matrix(rots[lo:hi]).mean().as_matrix()
        except ValueError:
            poses[i, :3, :3] = poses[i - 1, :3, :3] if i > 0 else rots[i]
    return poses


def get_cond_window(conds: np.ndarray, index: int, smo_win_size: int) -> np.ndarray:
    """Centered window of per-frame conditions, zero-padded at the edges."""
    T = conds.shape[0]
    left = index - smo_win_size // 2
    right = index + (smo_win_size - smo_win_size // 2)
    pad_left = max(0, -left)
    pad_right = max(0, right - T)
    win = conds[max(0, left) : min(T, right)]
    if pad_left or pad_right:
        win = np.pad(win, [(pad_left, pad_right)] + [(0, 0)] * (conds.ndim - 1))
    return win


class RADNeRFDataset:
    """Inference frame store; ``prefix`` ∈ {train, val, trainval}."""

    def __init__(self, prefix: str, data_dir: str, cfg):
        self.cfg = cfg
        ds = np.load(
            os.path.join(data_dir, "trainval_dataset.npy"), allow_pickle=True
        ).tolist()
        if prefix == "train":
            self.samples = list(ds["train_samples"])
        elif prefix == "val":
            self.samples = list(ds["val_samples"])
        elif prefix == "trainval":
            self.samples = list(ds["train_samples"]) + list(ds["val_samples"])
        else:
            raise ValueError(f"bad prefix {prefix}")

        self.H, self.W = int(ds["H"]), int(ds["W"])
        self.focal = float(ds["focal"])
        self.cx, self.cy = float(ds["cx"]), float(ds["cy"])
        self.bg_img = np.asarray(ds["bg_img"], np.float32) / 255.0
        self.idexp_lm3d_mean = ds.get("idexp_lm3d_mean")
        self.idexp_lm3d_std = ds.get("idexp_lm3d_std")
        self.intrinsics = (self.focal, self.focal, self.cx, self.cy)

        self.poses = np.stack(
            [
                nerf_matrix_to_ngp(
                    s["c2w"],
                    scale=cfg.get("camera_scale", 4.0),
                    offset=cfg.get("camera_offset", [0, 0, 0]),
                )
                for s in self.samples
            ]
        )
        if np.isnan(self.poses).any():
            raise ValueError("NaN in c2w poses — check the face tracker output")
        if cfg.get("infer_smooth_camera_path", True):
            self.poses = smooth_camera_path(
                self.poses, cfg.get("infer_smooth_camera_path_kernel_size", 7)
            )
        self.poses6 = convert_poses(self.poses)
        self.bg_coords = get_bg_coords(self.H, self.W)[0]  # [H*W, 2]

        cond_type = cfg.get("cond_type", "idexp_lm3d_normalized")
        if cond_type == "deepspeech":
            self.conds = np.stack([s["deepspeech_win"] for s in self.samples])
        elif cond_type == "esperanto":
            self.conds = np.stack([s["esperanto_win"] for s in self.samples])
        elif cond_type == "idexp_lm3d_normalized":
            w = cfg.get("cond_win_size", 1)
            self.conds = np.stack(
                [
                    np.asarray(s["idexp_lm3d_normalized_win"], np.float32).reshape(w, 204)
                    for s in self.samples
                ]
            )
        else:
            raise NotImplementedError(cond_type)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int) -> dict:
        sample = self.samples[idx]
        rays = get_rays(self.poses[idx], self.intrinsics, self.H, self.W)
        torso = np.asarray(sample["torso_img"], np.float32)
        if torso.max() > 1.5:
            torso = torso / 255.0
        # torso composited onto bg is the head's background
        if torso.shape[-1] == 4:
            alpha = torso[..., 3:]
            bg_torso = torso[..., :3] * alpha + self.bg_img * (1 - alpha)
        else:
            bg_torso = torso
        return {
            "H": self.H,
            "W": self.W,
            "idx": int(sample.get("idx", idx)),
            "pose": self.poses6[idx : idx + 1],  # [1, 6]
            "pose_matrix": self.poses[idx],
            "cond_wins": get_cond_window(
                self.conds, idx, self.cfg.get("smo_win_size", 5)
            ),
            "rays_o": rays["rays_o"].astype(np.float32),
            "rays_d": rays["rays_d"].astype(np.float32),
            "bg_coords": self.bg_coords.astype(np.float32),
            "bg_img": self.bg_img.reshape(-1, 3),
            "bg_torso_img": bg_torso.reshape(-1, 3).astype(np.float32),
        }
