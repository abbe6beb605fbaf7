"""RAD-NeRF per-video frame store (port of
``geneface_tpu/data/radnerf_dataset.py``).

Reads the binarizer's ``trainval_dataset.npy`` and converts poses to the ngp
convention. For inference it smooths the camera path and serves full-frame
rays plus the background the head is composited over. For training it
serves random ray batches drawn from its seeded ``RandomState``: a light
batch of pixel indices, the face rect and uint8 pixels (rays are rebuilt on
the device, as the JAX package's default ``device_rays`` does), one frame
per step in a shuffled, prefetched epoch order. While ``finetune_lip_flag``
is set (the lip fine-tune phase), a training item is instead the
``lip_patch_size``² square patch centred on the frame's lip rect (clipped
into the frame), row-major, marked ``is_lip_patch``.

A training dataset gathers the sampled pixels with the native C++ loader
(:class:`~geneface_tpu_torch.native.NativeBatchLoader`: uint8 frame planes
built once, the torso composited over the background in fixed point), as
the JAX package does by default; ``native_loader: false`` chooses the numpy
path (the float composite rounded to uint8, within one level of the native
one). A failed native build raises: nothing falls back silently.
"""

from __future__ import annotations

import os
import queue
import threading

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


def _to_u8(a: np.ndarray) -> np.ndarray:
    return np.clip(a * 255.0 + 0.5, 0, 255).astype(np.uint8)


class RADNeRFDataset:
    """``prefix`` ∈ {train, val, trainval}; ``training`` (default: the
    train split) selects random ray batches over full frames."""

    def __init__(self, prefix: str, data_dir: str, cfg, training: bool | None = None):
        self.cfg = cfg
        self.training = training if training is not None else prefix == "train"
        self.rng = np.random.RandomState(cfg.get("seed", 9999))
        # epoch shuffling draws from its own stream, so the prefetching
        # iterator sees the same values as the synchronous path
        self.order_rng = np.random.RandomState(cfg.get("seed", 9999) + 1)
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
        if not self.training and cfg.get("infer_smooth_camera_path", True):
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
        self.lips_rects = [self._lip_rect(s) for s in self.samples]
        self.finetune_lip_flag = False
        self.native_loader = (self._build_native_loader()
                              if self.training and cfg.get("native_loader", True) else None)

    def _build_native_loader(self):
        """The frames as uint8 planes ([T, HW, 3] ground truth, [T, HW, 3|4]
        torso, [HW, 3] background) behind a native loader."""
        from geneface_tpu_torch.native import NativeBatchLoader

        def u8(a):
            a = np.asarray(a)
            return a if a.dtype == np.uint8 else _to_u8(a)

        HW = self.H * self.W
        gt = np.stack([u8(s["gt_img"]).reshape(HW, -1)[:, :3] for s in self.samples])
        torso = np.stack([u8(s["torso_img"]).reshape(HW, -1) for s in self.samples])
        return NativeBatchLoader(gt, torso, u8(self.bg_img).reshape(HW, 3), n_threads=2)

    def _lip_rect(self, sample) -> tuple:
        """(xmin, xmax, ymin, ymax) of the lips: the sample's ``lip_rect``,
        else the square around ``lms[48:60]`` (x from the landmarks' second
        column), else the face rect."""
        if "lip_rect" in sample:
            return tuple(int(v) for v in sample["lip_rect"])
        lms = sample.get("lms")
        if lms is None:
            xmin, xmax, ymin, ymax = sample["face_rect"]
            return (int(xmin), int(xmax), int(ymin), int(ymax))
        lips = np.asarray(lms)[48:60]
        xmin, xmax = int(lips[:, 1].min()), int(lips[:, 1].max())
        ymin, ymax = int(lips[:, 0].min()), int(lips[:, 0].max())
        cx, cy = (xmin + xmax) // 2, (ymin + ymax) // 2
        half = max(xmax - xmin, ymax - ymin) // 2
        return (max(0, cx - half), min(self.H, cx + half),
                max(0, cy - half), min(self.W, cy + half))

    def lip_patch(self, idx: int) -> tuple:
        """The ``lip_patch_size``² patch centred on frame ``idx``'s lip rect,
        clipped into the frame: (xmin, xmax, ymin, ymax)."""
        P = int(self.cfg.get("lip_patch_size", 64))
        xmin, xmax, ymin, ymax = self.lips_rects[idx]
        cx = np.clip((xmin + xmax) // 2, P // 2, self.H - P // 2)
        cy = np.clip((ymin + ymax) // 2, P // 2, self.W - P // 2)
        return (cx - P // 2, cx + P // 2, cy - P // 2, cy + P // 2)

    def __len__(self):
        return len(self.samples)

    @staticmethod
    def _gt(sample) -> np.ndarray:
        """The frame's ground truth [H, W, 3] in [0, 1]."""
        gt = np.asarray(sample["gt_img"], np.float32)
        if gt.max() > 1.5:
            gt = gt / 255.0
        return gt[..., :3]

    def _bg_torso(self, sample) -> np.ndarray:
        """The torso composited onto the background: the head's background."""
        torso = np.asarray(sample["torso_img"], np.float32)
        if torso.max() > 1.5:
            torso = torso / 255.0
        if torso.shape[-1] == 4:
            alpha = torso[..., 3:]
            return torso[..., :3] * alpha + self.bg_img * (1 - alpha)
        return torso

    def __getitem__(self, idx: int) -> dict:
        if self.training:
            return self._train_item(idx)
        sample = self.samples[idx]
        rays = get_rays(self.poses[idx], self.intrinsics, self.H, self.W)
        bg_torso = self._bg_torso(sample)
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

    def _train_item(self, idx: int) -> dict:
        """One training batch of frame ``idx``: ``n_rays`` random pixels, or
        in the lip phase its lip patch."""
        cfg = self.cfg
        sample = self.samples[idx]
        out = {
            "H": self.H,
            "W": self.W,
            "idx": int(sample.get("idx", idx)),
            "pose": self.poses6[idx : idx + 1],  # [1, 6], the torso's input
            "pose_matrix": self.poses[idx],
            "lip_rect": self.lips_rects[idx],
            "cond_wins": get_cond_window(self.conds, idx, cfg.get("smo_win_size", 5)),
        }
        if self.finetune_lip_flag:
            out["lip_rect"] = self.lip_patch(idx)
            out["is_lip_patch"] = True
            inds = get_rays(self.poses[idx], self.intrinsics, self.H, self.W,
                            n_rays=1, rect=out["lip_rect"])["inds"]
        else:
            inds = get_rays(
                self.poses[idx], self.intrinsics, self.H, self.W,
                n_rays=cfg.get("n_rays", 65536), rng=self.rng,
            )["inds"]
        # a light batch: rays, background coords and the face mask are
        # rebuilt on the device from the pixel indices
        out["inds"] = inds.astype(np.int32)
        out["face_rect"] = np.asarray(sample["face_rect"], np.float32)
        if self.native_loader is not None:
            (out["gt_img_u8"], out["bg_img_u8"],
             out["bg_torso_img_u8"]) = self.native_loader.gather(idx, out["inds"])
            return out
        gt = self._gt(sample)
        out["gt_img_u8"] = _to_u8(gt.reshape(-1, 3)[inds])
        out["bg_img_u8"] = _to_u8(self.bg_img.reshape(-1, 3)[inds])
        out["bg_torso_img_u8"] = _to_u8(self._bg_torso(sample).reshape(-1, 3)[inds])
        return out

    def iter_epochs(self, prefetch: bool = True):
        """Infinite per-frame iterator in shuffled epoch order. With
        ``prefetch`` one daemon thread builds the next batch while the
        caller's step runs; item order and draws are those of a synchronous
        loop, and only a ``finetune_lip_flag`` change takes effect one item
        late (as in the JAX package)."""

        def indices():
            while True:
                order = np.arange(len(self))
                self.order_rng.shuffle(order)
                yield from order

        it = indices()
        if not prefetch:
            for i in it:
                yield self[int(i)]
            return
        jobs: queue.Queue = queue.Queue(maxsize=2)
        results: queue.Queue = queue.Queue(maxsize=2)

        def worker():
            while True:
                i = jobs.get()
                if i is None:
                    return
                try:
                    results.put((self[int(i)], None))
                except Exception as e:  # raised again in the consumer
                    results.put((None, e))
                    return

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            jobs.put(int(next(it)))
            for i in it:
                jobs.put(int(i))
                item, err = results.get()
                if err is not None:
                    raise err
                yield item
        finally:
            try:
                jobs.put_nowait(None)
            except queue.Full:
                pass
