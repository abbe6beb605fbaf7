"""3DMM landmark helper: BFM basis reconstruction + landmark editing (a
copy of ``geneface_tpu/utils/face3d.py``, numpy).

Re-implementation of ``data_util/face3d_helper.py``: loads the Basel Face
Model keypoint bases from ``BFM_model_front.mat`` and reconstructs the
**idexp_lm3d** representation ``(id_base·id + exp_base·exp) · 10``
(``face3d_helper.py:84-99``), plus the eye/mouth landmark slicing and the
close-mouth / close-eyes landmark edits used by inference post-processing.

The BFM assets are licensed and not shipped; basis-dependent methods raise a
clear error when the .mat is absent, while the pure-landmark utilities
(slicing, editing) work standalone.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["Face3DHelper", "get_eye_mouth_lm_from_lm3d", "close_mouth", "close_eyes"]


def get_eye_mouth_lm_from_lm3d(lm3d: np.ndarray):
    """lm3d [..., 68, 3] → (eye [..., 31, 3], mouth [..., 20, 3])
    (``face3d_helper.py:101-109``)."""
    return lm3d[..., 17:48, :], lm3d[..., 48:68, :]


def close_mouth(idexp_lm3d: np.ndarray, freeze_as_first_frame: bool = True):
    """Pull the lip landmarks together (``face3d_helper.py:129-145``)."""
    lm = np.array(idexp_lm3d, np.float32).reshape(-1, 68, 3)
    eps = 0.0
    upper_outer = slice(49, 54)
    lower_outer = list(range(59, 54, -1))
    mid_outer = 0.5 * (lm[:, upper_outer, 1] + lm[:, lower_outer, 1])
    lm[:, upper_outer, 1] = mid_outer + eps * 2
    lm[:, lower_outer, 1] = mid_outer - eps * 2
    upper_inner = slice(61, 64)
    lower_inner = list(range(67, 64, -1))
    mid_inner = 0.5 * (lm[:, upper_inner, 1] + lm[:, lower_inner, 1])
    lm[:, upper_inner, 1] = mid_inner + eps
    lm[:, lower_inner, 1] = mid_inner - eps
    lm[:, upper_outer, 1] += (
        0.03 - lm[:, upper_outer, 1].mean(1) + lm[:, upper_inner, 1].mean(1)
    )[:, None]
    lm[:, lower_outer, 1] += (
        -0.03 - lm[:, lower_outer, 1].mean(1) + lm[:, lower_inner, 1].mean(1)
    )[:, None]
    if freeze_as_first_frame:
        lm[:, 48:68] = 0.0
    return lm


def close_eyes(idexp_lm3d: np.ndarray):
    """Close the eyelids (``face3d_helper.py:147-157``)."""
    lm = np.array(idexp_lm3d, np.float32).reshape(-1, 68, 3)
    for upper, lower in [
        (slice(37, 39), list(range(41, 39, -1))),
        (slice(43, 45), list(range(47, 45, -1))),
    ]:
        mid = 0.5 * (lm[:, upper, 1] + lm[:, lower, 1])
        lm[:, upper, 1] = mid
        lm[:, lower, 1] = mid
    return lm


class Face3DHelper:
    def __init__(self, bfm_dir: str = "deep_3drecon/BFM"):
        self.bfm_dir = bfm_dir
        self._loaded = False

    def _load(self):
        if self._loaded:
            return
        path = os.path.join(self.bfm_dir, "BFM_model_front.mat")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"BFM model not found at {path}; download the Basel Face Model "
                "assets (see the data preparation docs) to use 3DMM "
                "reconstruction"
            )
        from scipy.io import loadmat

        model = loadmat(path)
        kp = model["keypoints"].squeeze().astype(np.int64) - 1  # 1-based
        mean_shape = model["meanshape"].reshape(-1, 3)
        mean_shape = mean_shape - mean_shape.mean(0, keepdims=True)
        id_base = model["idBase"].reshape(-1, 3, model["idBase"].shape[-1])
        exp_base = model["exBase"].reshape(-1, 3, model["exBase"].shape[-1])
        self.key_mean_shape = mean_shape[kp]  # [68, 3]
        self.key_id_base = id_base[kp].reshape(68 * 3, -1)  # [204, 80]
        self.key_exp_base = exp_base[kp].reshape(68 * 3, -1)  # [204, 64]
        self.mean_shape = mean_shape
        self.id_base = model["idBase"]
        self.exp_base = model["exBase"]
        self._loaded = True

    def split_coeff(self, coeff: np.ndarray) -> dict:
        """257-D Deep3DRecon coefficient → named parts
        (``face3d_helper.py:30-42``)."""
        return {
            "identity": coeff[..., :80],
            "expression": coeff[..., 80:144],
            "texture": coeff[..., 144:224],
            "euler": coeff[..., 224:227],
            "translation": coeff[..., 254:257],
        }

    def reconstruct_lm3d(self, id_coeff, exp_coeff):
        """[T, 80], [T, 64] → [T, 68, 3] mean + id/exp offsets."""
        self._load()
        out = (
            self.key_mean_shape.reshape(1, -1)
            + id_coeff @ self.key_id_base.T
            + exp_coeff @ self.key_exp_base.T
        )
        return out.reshape(-1, 68, 3)

    def reconstruct_idexp_lm3d(self, id_coeff, exp_coeff):
        """``(id_base·id + exp_base·exp) · 10`` (``face3d_helper.py:84-99``)."""
        self._load()
        out = (id_coeff @ self.key_id_base.T + exp_coeff @ self.key_exp_base.T) * 10.0
        return out.reshape(-1, 68, 3)

    # landmark-only utilities (no BFM needed)
    get_eye_mouth_lm_from_lm3d = staticmethod(get_eye_mouth_lm_from_lm3d)
    close_mouth_for_idexp_lm3d = staticmethod(close_mouth)
    close_eyes_for_idexp_lm3d = staticmethod(close_eyes)
