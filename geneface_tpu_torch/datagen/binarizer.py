"""Binarizers: processed artifacts → training stores (port of
``geneface_tpu/datagen/binarizer.py``).

- :func:`binarize_video`: the per-video store ``trainval_dataset.npy``
  (frames, the mask-derived images, tracked poses, audio features and the
  normalized idexp landmarks) that
  :class:`geneface_tpu_torch.data.radnerf_dataset.RADNeRFDataset` reads;
- :func:`binarize_lrs3`: per-clip (mel, f0, hubert, idexp_lm3d) features
  in ``IndexedDataset`` train/val shards (1% validation).
"""

from __future__ import annotations

import json
import os

import numpy as np

from geneface_tpu_torch.utils.indexed_dataset import IndexedDatasetBuilder

__all__ = ["get_win_conds", "binarize_video", "binarize_lrs3"]


def get_win_conds(conds: np.ndarray, idx: int, win: int, pad_mode="edge"):
    """Window of ``win`` frames centred at ``idx``, edge-padded."""
    left = idx - win // 2
    right = left + win
    pad_l = max(0, -left)
    pad_r = max(0, right - len(conds))
    w = conds[max(0, left) : min(len(conds), right)]
    if pad_l or pad_r:
        w = np.pad(w, [(pad_l, pad_r)] + [(0, 0)] * (conds.ndim - 1), pad_mode)
    return w


def _idexp_from_track(track: dict, basis) -> np.ndarray:
    """Tracker (id, exp) → idexp_lm3d [T, 68, 3] in the reference's ×10
    space: (id_base·id + exp_base·exp)·10."""
    idp = np.asarray(track["id"])
    exp = np.asarray(track["exp"])
    ib = np.asarray(basis.id_base.cpu(), np.float32)
    eb = np.asarray(basis.exp_base.cpu(), np.float32)
    out = (ib @ idp)[None] + exp @ eb.T  # [T, 204]
    return (out * 10.0).reshape(len(exp), 68, 3).astype(np.float32)


def binarize_video(
    manifest: dict,  # output of datagen.process.process_video / process_frames
    out_dir: str,
    basis=None,
    idexp_lm3d: np.ndarray | None = None,  # [T, 68, 3] overrides the tracker
    cond_win_size: int = 1,
    val_every: int = 11,
) -> str:
    """→ ``<out_dir>/trainval_dataset.npy``."""
    H, W = manifest["H"], manifest["W"]
    track = manifest["track"]
    splits = manifest["splits"]
    T = len(splits)

    if idexp_lm3d is None:
        if basis is None:
            raise ValueError("need a FaceBasis (or precomputed idexp_lm3d)")
        idexp_lm3d = _idexp_from_track(track, basis)
    idexp_lm3d = np.asarray(idexp_lm3d, np.float32).reshape(T, 68, 3)
    mean = idexp_lm3d.mean(0)
    std = idexp_lm3d.std(0) + 1e-8
    norm = ((idexp_lm3d - mean) / std).reshape(T, 204)

    from geneface_tpu_torch.utils.camera import euler_trans_to_c2w

    w2c = euler_trans_to_c2w(
        np.asarray(track["euler"]), np.asarray(track["trans"])
    )
    c2w = np.linalg.inv(w2c).astype(np.float32)

    # audio features at 2 frames per video frame (100 fps audio / 25 fps video
    # → the reference stores 4-frame hops; here mel hop 160 = 100 fps → 4)
    audio = manifest.get("audio", {})
    hubert = audio.get("hubert")
    mel = audio.get("mel")
    f0 = audio.get("f0")

    samples = []
    for t in range(T):
        s = {
            "idx": t,
            "c2w": c2w[t],
            "gt_img": splits[t]["gt_img"],
            "head_img": splits[t]["head_img"],
            "torso_img": splits[t]["torso_img"],
            "face_rect": [int(v) for v in manifest["face_rects"][t]],
            "lms": manifest["lms"][t].astype(np.float32),
            "idexp_lm3d_normalized_win": get_win_conds(
                norm, t, cond_win_size
            ).astype(np.float32),
        }
        samples.append(s)

    n_val = max(1, T // val_every)
    ds = {
        "H": H,
        "W": W,
        "focal": float(track["focal"]),
        "cx": W / 2.0,
        "cy": H / 2.0,
        "bg_img": manifest["bg_img"],
        "idexp_lm3d_mean": mean.astype(np.float32),
        "idexp_lm3d_std": std.astype(np.float32),
        "train_samples": samples[:-n_val],
        "val_samples": samples[-n_val:],
    }
    if hubert is not None:
        ds["hubert"] = hubert.astype(np.float32)
    if mel is not None:
        ds["mel"] = mel.astype(np.float32)
    if f0 is not None:
        ds["f0"] = f0.astype(np.float32)

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trainval_dataset.npy")
    np.save(path, ds, allow_pickle=True)
    return path


def binarize_lrs3(
    clips: list[dict],  # per-clip: {id, mel [T2,80], f0 [T2], hubert [T2,1024],
    #                     idexp_lm3d [T,204]}
    out_dir: str,
    val_percent: float = 0.01,
) -> tuple[str, str]:
    """→ (train_prefix, val_prefix) IndexedDataset shards
    (``process_lrs3/binarizer.py:1-90``)."""
    os.makedirs(out_dir, exist_ok=True)
    n_val = max(1, int(len(clips) * val_percent))
    split = {"val": clips[:n_val], "train": clips[n_val:]}
    prefixes = {}
    for prefix, items in split.items():
        p = os.path.join(out_dir, prefix)
        b = IndexedDatasetBuilder(p)
        for it in items:
            b.add_item(it)
        b.finalize()
        prefixes[prefix] = p
    meta = {
        "n_train": len(split["train"]),
        "n_val": len(split["val"]),
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return prefixes["train"], prefixes["val"]
