"""Landmark clean-up for inference (numpy copies of the steps of
``geneface_tpu/inference/landmark_postprocess.py`` that the head render
uses): per-region clamp, causal EMA, temporal Gaussian, centered windows."""

from __future__ import annotations

import numpy as np

__all__ = [
    "clamp_lm3d_regions",
    "ema_smooth_lm3d",
    "gaussian_smooth_lm3d",
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


def gaussian_smooth_lm3d(lm: np.ndarray, sigma: float) -> np.ndarray:
    """Temporal Gaussian smoothing (scipy, imported only when used)."""
    if sigma <= 0:
        return lm
    from scipy.ndimage import gaussian_filter1d

    return gaussian_filter1d(lm, sigma=sigma, axis=0)


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
