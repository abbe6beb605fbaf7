"""Landmark clean-up for inference (numpy copies of the steps of
``geneface_tpu/inference/landmark_postprocess.py`` that the head renders
use): per-region clamp, causal EMA, the LLE projection toward the training
video's landmarks, eye blinks (periodic or from the ground truth), a closed
mouth on silence, temporal Gaussian, centered windows."""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "clamp_lm3d_regions",
    "ema_smooth_lm3d",
    "lle_project_lm3d",
    "gaussian_smooth_lm3d",
    "inject_blinks",
    "inject_blinks_from_gt",
    "close_mouth_when_silent",
    "get_win_conds",
]

REGIONS = {
    "jaw": slice(0, 17),
    "brow": slice(17, 27),
    "nose": slice(27, 36),
    "eye": slice(36, 48),
    "mouth": slice(48, 68),
}


def clamp_lm3d_regions(lm: np.ndarray, clamp_std: float = 2.5) -> np.ndarray:
    """Per-region clamp of normalized lm3d [T, 68, 3]; brow/eye x,y get half
    the band."""
    lm = lm.copy()
    for name in ("jaw", "nose", "mouth"):
        lm[:, REGIONS[name]] = np.clip(lm[:, REGIONS[name]], -clamp_std, clamp_std)
    for name in ("brow", "eye"):
        sl = REGIONS[name]
        lm[:, sl, 0:2] = np.clip(lm[:, sl, 0:2], -clamp_std / 2, clamp_std / 2)
        lm[:, sl, 2] = np.clip(lm[:, sl, 2], -clamp_std, clamp_std)
    return lm


def ema_smooth_lm3d(
    lm: np.ndarray, lambda_other: float = 0.2, lambda_lip: float = 0.2
) -> np.ndarray:
    """Causal EMA per region."""
    lm = lm.copy()
    moving = lm[0].copy()
    for i in range(len(lm)):
        for name, sl in REGIONS.items():
            lam = lambda_lip if name == "mouth" else lambda_other
            lm[i, sl] = lam * moving[sl] + (1 - lam) * lm[i, sl]
        moving = lm[i].copy()
    return lm


def lle_project_lm3d(lm: np.ndarray, database: np.ndarray, percent: float, K: int = 10,
                     device=None) -> np.ndarray:
    """Blend ``lm [T, 68, 3]`` toward its LLE projection onto ``database
    [N, 68*3]`` (float32, on ``device``, the card by default):
    ``(1 - percent)·lm + percent·fused``; ``K`` is capped at ``N``."""
    if percent <= 0:
        return lm
    from geneface_tpu_torch import resolve_device
    from geneface_tpu_torch.models.postnet.lle import compute_lle_projection

    dev = resolve_device(device)
    K = min(K, len(database))
    feats = torch.as_tensor(lm.reshape(len(lm), -1), dtype=torch.float32, device=dev)
    db = torch.as_tensor(database.reshape(len(database), -1), dtype=torch.float32, device=dev)
    fused, _ = compute_lle_projection(feats, db, K)
    return (1 - percent) * lm + percent * fused.cpu().numpy().reshape(lm.shape)


def gaussian_smooth_lm3d(lm: np.ndarray, sigma: float) -> np.ndarray:
    """Temporal Gaussian smoothing (scipy, imported only when used)."""
    if sigma <= 0:
        return lm
    from scipy.ndimage import gaussian_filter1d

    return gaussian_filter1d(lm, sigma=sigma, axis=0)


def inject_blinks(
    lm: np.ndarray, closed_eye_lm: np.ndarray, period_s: float = 5.0,
    fps: int = 25, blink_frames: int = 5,
) -> np.ndarray:
    """Periodic eye blinks: every ``period_s`` the eye landmarks ramp to
    ``closed_eye_lm``'s and back over ``blink_frames`` frames."""
    lm = lm.copy()
    period = int(period_s * fps)
    for start in range(period, len(lm) - blink_frames, period):
        for j in range(blink_frames):
            w = 1.0 - abs(j - blink_frames // 2) / (blink_frames // 2 + 1e-6)
            lm[start + j, REGIONS["eye"]] = (
                w * closed_eye_lm[REGIONS["eye"]]
                + (1 - w) * lm[start + j, REGIONS["eye"]]
            )
    return lm


def inject_blinks_from_gt(
    lm: np.ndarray,
    gt_lm_db: np.ndarray,
    mode: str = "none",
    ref_start: int | None = None,
    ref_end: int | None = None,
) -> np.ndarray:
    """Replace the brow and eye landmarks (17:48) of ``lm [T, 68, 3]`` with
    ground-truth motion from ``gt_lm_db [N, 68, 3]`` (both normalized):
    ``period`` tiles the segment ``[ref_start, ref_end]`` over the
    sequence, ``gt`` tiles the whole ground truth, ``none`` leaves ``lm``."""
    if mode == "none":
        return lm
    db = gt_lm_db.reshape(len(gt_lm_db), 68, 3)
    if mode == "period":
        if ref_start is None or ref_end is None:
            raise ValueError(
                "period blink mode needs infer_eye_blink_ref_frames_"
                "start/end_idx (a GT blink segment)"
            )
        pattern = db[ref_start : ref_end + 1, 17:48]
    elif mode == "gt":
        pattern = db[:, 17:48]
    else:
        raise NotImplementedError(f"blink mode {mode}")
    reps = len(lm) // len(pattern) + 1
    tiled = np.concatenate([pattern] * reps, axis=0)[: len(lm)]
    out = lm.copy()
    out[:, 17:48] = tiled
    return out


def close_mouth_when_silent(
    lm: np.ndarray, mel: np.ndarray, closed_mouth_lm: np.ndarray,
    energy_thresh: float = -4.0,
) -> np.ndarray:
    """Frame ``i`` of ``lm [T, 68, 3]`` takes ``closed_mouth_lm``'s mouth
    when the mean of mel frame ``2i`` (``mel [2T, 80]``, the last one past
    the end) is under ``energy_thresh``."""
    lm = lm.copy()
    energy = mel.mean(-1)
    for i in range(len(lm)):
        e = energy[min(2 * i, len(energy) - 1)]
        if e < energy_thresh:
            lm[i, REGIONS["mouth"]] = closed_mouth_lm[REGIONS["mouth"]]
    return lm


def get_win_conds(conds: np.ndarray, idx: int, smo_win_size: int,
                  pad_option: str = "edge") -> np.ndarray:
    """Centered window with edge (or zero) padding."""
    left = idx - smo_win_size // 2
    right = idx + (smo_win_size - smo_win_size // 2)
    pad_l, pad_r = max(0, -left), max(0, right - len(conds))
    win = conds[max(0, left) : min(len(conds), right)]
    if pad_l or pad_r:
        if pad_option == "edge":
            win = np.concatenate(
                [np.repeat(win[:1], pad_l, 0), win, np.repeat(win[-1:], pad_r, 0)]
            )
        else:
            win = np.pad(win, [(pad_l, pad_r)] + [(0, 0)] * (win.ndim - 1))
    return win
