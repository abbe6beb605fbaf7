"""RAD-NeRF head inference: checkpoint + landmarks → frames (port of
``geneface_tpu/inference/radnerf_infer.py``, head only).

Per video: load the checkpoint (JAX-written or the port's own), build the
per-video constants once — the 13-slab k-DOP of the occupied cells, the ray
capacity probed from a few dataset poses, the packed occupancy blocks and
the dense grid views — then render every frame through the culled compact
renderer. :meth:`RADNeRFInfer.render_frames` returns uint8 frames;
:meth:`RADNeRFInfer.render_video` muxes them with :func:`save_mp4`.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np
import torch

from geneface_tpu_torch import resolve_device
from geneface_tpu_torch.convert import flax_to_state_dict
from geneface_tpu_torch.data.radnerf_dataset import RADNeRFDataset, get_cond_window
from geneface_tpu_torch.inference.landmark_postprocess import (
    clamp_lm3d_regions,
    ema_smooth_lm3d,
    gaussian_smooth_lm3d,
    get_win_conds,
)
from geneface_tpu_torch.models.radnerf import (
    kdop_hit,
    model_from_cfg,
    occupancy_view,
    occupied_kdop,
    render_rays_radnerf,
)
from geneface_tpu_torch.utils.checkpoint import get_last_checkpoint, load_checkpoint

__all__ = ["RADNeRFInfer", "save_mp4", "pick_ray_capacity"]


def pick_ray_capacity(n_hit: int, n_total: int, headroom: float = 1.15,
                      quantum: int = 4096) -> int | None:
    """Static ray-cull capacity from a probed hit count: pad ``headroom``,
    round up to ``quantum``; ``None`` (no cull) when it would not cut."""
    if n_hit <= 0:
        return None
    cap = int(-(-int(n_hit * headroom) // quantum) * quantum)
    return cap if cap < n_total else None


def save_mp4(frames: np.ndarray, out_path: str, fps: int = 25,
             audio_path: str | None = None) -> str:
    """Frames [T, H, W, 3] (uint8, or float in [0,1]) + audio → mp4 (cv2
    and ffmpeg are needed here only)."""
    import cv2

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    tmp = out_path + ".noaudio.mp4"
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = (np.clip(frames, 0.0, 1.0) * 255).astype(np.uint8)
    h, w = frames.shape[1:3]
    vw = cv2.VideoWriter(tmp, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()
    if audio_path and os.path.exists(audio_path):
        subprocess.run(
            ["ffmpeg", "-y", "-v", "quiet", "-i", tmp, "-i", audio_path,
             "-c:v", "copy", "-c:a", "aac", "-shortest", out_path],
            check=True,
        )
        os.remove(tmp)
    else:
        os.replace(tmp, out_path)
    return out_path


class RADNeRFInfer:
    """Head-only renderer. ``device`` defaults to ``cuda`` (raises without a
    card); ``dtype`` is the field MLPs' compute dtype (bf16, as the JAX
    model's default)."""

    def __init__(self, cfg, work_dir: str | None = None, device=None,
                 dtype: torch.dtype = torch.bfloat16):
        self.cfg = cfg
        self.device = resolve_device(device)
        work_dir = work_dir or cfg.get("work_dir")
        path = get_last_checkpoint(work_dir)
        if path is None:
            raise FileNotFoundError(f"no model_ckpt_steps_*.ckpt under {work_dir}")
        state = load_checkpoint(path)["state"]
        if "torso_occ" in state:
            raise NotImplementedError("torso checkpoints are not ported yet")
        self.model = model_from_cfg(cfg, dtype=dtype)
        sd = {k: torch.from_numpy(v) for k, v in flax_to_state_dict(state["params"]).items()}
        self.model.load_state_dict(sd)
        self.model.to(self.device).eval()
        self.occ_grid = torch.tensor(np.asarray(state["occ"][1]), device=self.device)

        data_dir = cfg.get("data_dir") or (
            f"{cfg.get('binary_data_dir', 'data/binary/videos')}/{cfg.get('video_id', '')}"
        )
        self.dataset = RADNeRFDataset("trainval", data_dir, cfg)
        mspr = float(cfg.get("infer_mean_samples_per_ray", cfg.get("mean_samples_per_ray", 8)) or 0)
        lattice_K = int(cfg.get("infer_lattice_K", cfg.get("lattice_K", 48)) or 0)
        if not mspr or not lattice_K:
            raise NotImplementedError(
                "the port renders through the lattice march + compact path only "
                "(mean_samples_per_ray > 0 and lattice_K > 0)"
            )
        self.render_kwargs = dict(
            bound=float(cfg.get("bound", 1)),
            min_near=float(cfg.get("min_near", 0.05)),
            max_steps=int(cfg.get("max_steps", 16)),
            T_thresh=float(cfg.get("infer_T_thresh", 1e-4)),
            grid_size=int(cfg.get("grid_size", 128)),
            mean_samples_per_ray=mspr,
            lattice_K=lattice_K,
        )
        self.ray_capacity = None
        self.cull_kdop = None
        self._occ_view = None
        self._tables = None
        self.last_render = None  # output dict of the latest frame

    # ------------------------------------------------------------------
    def _pick_ray_capacity(self, n_probe: int = 4) -> int | None:
        """Ray-cull capacity for this video: the k-DOP hit count over a few
        dataset poses, padded 15% and rounded to 4096."""
        if not self.cfg.get("infer_ray_cull", True):
            return None
        ds = self.dataset
        bound = self.render_kwargs["bound"]
        min_near = self.render_kwargs["min_near"]
        self.cull_kdop = occupied_kdop(self.occ_grid, bound)
        n = 0
        for i in range(0, len(ds), max(1, len(ds) // n_probe))[:n_probe]:
            item = ds[i]
            hit = kdop_hit(
                torch.as_tensor(item["rays_o"], device=self.device),
                torch.as_tensor(item["rays_d"], device=self.device),
                self.cull_kdop, min_near,
            )
            n = max(n, int(hit.sum()))
        return pick_ray_capacity(n, ds.H * ds.W)

    def conds_from_lm3d(self, idexp_lm3d: np.ndarray) -> np.ndarray:
        """Raw idexp lm3d [T, 68, 3] → normalized cond windows [T, W, 204]."""
        cfg = self.cfg
        if cfg.get("infer_lm3d_lle_percent", 0.0) > 0:
            raise NotImplementedError("LLE landmark projection is not ported yet")
        mean = np.asarray(self.dataset.idexp_lm3d_mean)
        std = np.asarray(self.dataset.idexp_lm3d_std)
        lm = (idexp_lm3d.reshape(-1, 68, 3) - mean) / std
        lm = clamp_lm3d_regions(lm, cfg.get("infer_lm3d_clamp_std", 2.5))
        lm = ema_smooth_lm3d(lm)
        lm = gaussian_smooth_lm3d(lm, cfg.get("infer_lm3d_smooth_sigma", 0.0))
        flat = lm.reshape(-1, 204).astype(np.float32)
        W = cfg.get("cond_win_size", 1)
        return np.stack([get_win_conds(flat, i, W, "edge") for i in range(len(flat))])

    def prepare(self) -> None:
        """Per-video constants: ray capacity + k-DOP, occupancy blocks, grid
        views."""
        self.ray_capacity = self._pick_ray_capacity()
        if self.ray_capacity is None:
            self.cull_kdop = None
        self._occ_view = occupancy_view(self.occ_grid, self.render_kwargs["bound"])
        with torch.inference_mode():
            self._tables = self.model.grid_tables()

    @torch.inference_mode()
    def render_frame(self, i: int, conds: np.ndarray | None = None) -> dict:
        """Render frame ``i`` (dataset pose ``i`` mod its length, condition
        window centred on ``i``) after :meth:`prepare` → the renderer's
        output dict (``rgb_map`` [H*W, 3] float32, ...)."""
        ds = self.dataset
        dev = self.device
        conds = ds.conds if conds is None else conds
        item = ds[i % len(ds)]
        cond = get_cond_window(conds, i, self.cfg.get("smo_win_size", 5))
        model = self.model
        cond_feat = model.cal_cond_feat(torch.as_tensor(cond, device=dev))
        codes = model.individual_embeddings
        ind = codes[0] if codes is not None else None
        tables = self._tables

        def field_fn(xyz, dirs):
            return model(xyz, dirs, cond_feat, ind, tables)

        out = render_rays_radnerf(
            field_fn,
            torch.as_tensor(item["rays_o"], device=dev),
            torch.as_tensor(item["rays_d"], device=dev),
            self._occ_view,
            bg_color=torch.as_tensor(item["bg_torso_img"], device=dev),
            ray_capacity=self.ray_capacity, cull_kdop=self.cull_kdop,
            **self.render_kwargs,
        )
        self.last_render = out
        return out

    def render_frames(self, n_frames: int | None = None,
                      idexp_lm3d: np.ndarray | None = None) -> np.ndarray:
        """Render frames driven by ``idexp_lm3d`` (or the dataset's own
        conditions) over the dataset poses (looped) → uint8 [T, H, W, 3]."""
        ds = self.dataset
        conds = self.conds_from_lm3d(idexp_lm3d) if idexp_lm3d is not None else ds.conds
        self.prepare()
        frames = []
        for i in range(n_frames or len(conds)):
            rgb = self.render_frame(i, conds)["rgb_map"].reshape(ds.H, ds.W, 3)
            frames.append((rgb.clamp(0.0, 1.0) * 255).to(torch.uint8).cpu().numpy())
        return np.stack(frames)

    def render_video(self, idexp_lm3d: np.ndarray | None = None,
                     out_path: str = "infer_out/pred_video/out.mp4",
                     audio_path: str | None = None,
                     n_frames: int | None = None) -> str:
        """Render frames, then mux them (and the audio) into an mp4."""
        frames = self.render_frames(n_frames, idexp_lm3d)
        return save_mp4(frames, out_path, audio_path=audio_path)
