"""Per-frame dataset of the vanilla NeRF family (numpy copy of
``geneface_tpu/data/nerf_dataset.py``): raw (OpenGL-convention) c2w poses,
near/far from the config, the ground-truth frame, the background and the
condition windows, from the binarized ``trainval_dataset.npy`` that the
RAD-NeRF dataset reads too. A head item samples rays at the frame's pose
(most of them inside the face rect); a torso item samples the lower image
half at the canonical pose ``c2w_t0`` and the head rays at the same pixels
at the frame's pose. Head and torso items draw from one shared
``RandomState`` in the JAX package's order, so the same seed gives the same
pixels.
"""

from __future__ import annotations

import os

import numpy as np

from geneface_tpu_torch.data.radnerf_dataset import get_cond_window
from geneface_tpu_torch.data.ray_samplers import (
    FullRaySampler,
    TorsoUniformRaySampler,
    UniformRaySampler,
    get_rays_nerf,
    sample_pixels,
)
from geneface_tpu_torch.utils.camera import c2w_to_euler_trans

__all__ = ["NeRFDataset"]


class NeRFDataset:
    def __init__(self, prefix: str, data_dir: str, cfg, training=None, rng=None):
        self.cfg = cfg
        self.rng = rng or np.random.RandomState(cfg.get("seed", 9999))
        ds = np.load(
            os.path.join(data_dir, "trainval_dataset.npy"), allow_pickle=True
        ).tolist()
        if prefix == "train":
            self.samples = list(ds["train_samples"])
        elif prefix == "val":
            self.samples = list(ds["val_samples"])
        else:
            self.samples = list(ds["train_samples"]) + list(ds["val_samples"])
        self.training = training if training is not None else prefix == "train"

        self.H, self.W = int(ds["H"]), int(ds["W"])
        self.focal = float(ds["focal"])
        self.cx, self.cy = float(ds["cx"]), float(ds["cy"])
        self.near = cfg.get("near", 0.3)
        self.far = cfg.get("far", 0.9)
        self.bg_img = np.asarray(ds["bg_img"], np.float32) / 255.0
        # landmark normalization stats (used by the inference classes to
        # normalize predicted idexp lm3d, reference binarizer.py mean/std)
        self.idexp_lm3d_mean = ds.get("idexp_lm3d_mean")
        self.idexp_lm3d_std = ds.get("idexp_lm3d_std")

        cond_type = cfg.get("cond_type", "idexp_lm3d_normalized")
        if cond_type == "deepspeech":
            self.conds = np.stack([s["deepspeech_win"] for s in self.samples])
        elif cond_type == "esperanto":
            self.conds = np.stack([s["esperanto_win"] for s in self.samples])
        else:
            w = cfg.get("cond_win_size", 1)
            self.conds = np.stack(
                [
                    np.asarray(s["idexp_lm3d_normalized_win"], np.float32).reshape(
                        w, -1
                    )
                    for s in self.samples
                ]
            )
        self.sampler = UniformRaySampler(rng=self.rng)
        self.torso_sampler = TorsoUniformRaySampler(rng=self.rng)
        self.full_sampler = FullRaySampler(cfg.get("infer_scale_factor", 1.0))
        # head pose (euler-XYZ + translation) of the *w2c* transform, as the
        # face tracker emits it (reference dataset_utils.py:66-71); the torso
        # field is conditioned on it
        all_c2w = np.stack([np.asarray(s["c2w"], np.float32) for s in self.samples])
        w2c = np.linalg.inv(all_c2w)
        self.eulers, self.transs = c2w_to_euler_trans(w2c)
        self.c2w_t0 = np.asarray(self.samples[0]["c2w"], np.float32)
        self.euler_t0, self.trans_t0 = self.eulers[0], self.transs[0]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int) -> dict:
        cfg = self.cfg
        s = self.samples[idx]
        gt = np.asarray(s["gt_img"], np.float32)
        if gt.max() > 1.5:
            gt = gt / 255.0
        gt = gt[..., :3]
        c2w = np.asarray(s["c2w"], np.float32)
        # face rect (row_min, row_max, col_min, col_max) -> sampler rect
        # format (w1, h1, dw, dh) (ray_samplers.py:70)
        xmin, xmax, ymin, ymax = s["face_rect"]
        rect = (ymin, xmin, ymax - ymin, xmax - xmin)

        out = {
            "H": self.H, "W": self.W, "idx": int(s.get("idx", idx)),
            "near": self.near, "far": self.far, "c2w": c2w,
            "cond": self.conds[idx : idx + 1],
            "cond_wins": get_cond_window(
                self.conds, idx, cfg.get("smo_win_size", 5)
            ),
        }
        if self.training:
            ro, rd, coords = self.sampler(
                self.H, self.W, self.focal, c2w,
                n_rays=cfg.get("n_rays", 2048), rect=rect,
                in_rect_percent=cfg.get("in_rect_percent", 0.95),
                cx=self.cx, cy=self.cy,
            )
        else:
            ro, rd, coords = self.full_sampler(
                self.H, self.W, self.focal, c2w, cx=self.cx, cy=self.cy
            )
        out["rays_o"] = ro.astype(np.float32)
        out["rays_d"] = rd.astype(np.float32)
        out["gt_img"] = sample_pixels(gt, coords).astype(np.float32)
        out["bg_img"] = sample_pixels(self.bg_img, coords).astype(np.float32)
        return out

    def get_torso_item(self, idx: int) -> dict:
        """Torso-training sample (``tasks/nerfs/adnerf_torso.py:141-180``):
        torso rays in the canonical pose (``c2w_t0``) restricted to the lower
        image half, plus head rays at the *same pixel coords* in the current
        pose, composite target = full ``gt_img``."""
        cfg = self.cfg
        s = self.samples[idx]
        gt = np.asarray(s["gt_img"], np.float32)
        if gt.max() > 1.5:
            gt = gt / 255.0
        gt = gt[..., :3]
        c2w = np.asarray(s["c2w"], np.float32)

        out = {
            "idx": int(s.get("idx", idx)),
            "cond": self.conds[idx : idx + 1],
            "cond_wins": get_cond_window(
                self.conds, idx, cfg.get("smo_win_size", 5)
            ),
            "euler": self.eulers[idx],
            "trans": self.transs[idx],
            "euler_t0": self.euler_t0,
            "trans_t0": self.trans_t0,
        }
        if self.training:
            ro, rd, coords = self.torso_sampler(
                self.H, self.W, self.focal, self.c2w_t0,
                n_rays=cfg.get("n_rays", 2048),
                in_rect_percent=cfg.get("in_rect_percent", 0.95),
                cx=self.cx, cy=self.cy,
            )
        else:
            ro, rd, coords = self.full_sampler(
                self.H, self.W, self.focal, self.c2w_t0, cx=self.cx, cy=self.cy
            )
        ro_h_full, rd_h_full = get_rays_nerf(
            self.H, self.W, self.focal, c2w, cx=self.cx, cy=self.cy
        )
        out["rays_o"] = ro.astype(np.float32)
        out["rays_d"] = rd.astype(np.float32)
        out["rays_o_head"] = sample_pixels(ro_h_full, coords).astype(np.float32)
        out["rays_d_head"] = sample_pixels(rd_h_full, coords).astype(np.float32)
        out["gt_img"] = sample_pixels(gt, coords).astype(np.float32)
        out["bg_img"] = sample_pixels(self.bg_img, coords).astype(np.float32)
        return out

    def iter_torso_epochs(self, start_step: int = 0, shuffle: bool = True):
        while True:
            order = np.arange(len(self))
            if shuffle:
                self.rng.shuffle(order)
            for i in order:
                yield self.get_torso_item(int(i))

    def iter_epochs(self, start_step: int = 0, shuffle: bool = True):
        while True:
            order = np.arange(len(self))
            if shuffle:
                self.rng.shuffle(order)
            for i in order:
                yield self[int(i)]
