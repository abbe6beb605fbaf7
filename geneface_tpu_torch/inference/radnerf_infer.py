"""RAD-NeRF inference: checkpoint + landmarks → frames (port of
``geneface_tpu/inference/radnerf_infer.py``, head or head+torso).

Per video: load the checkpoint (JAX-written or the port's own; one whose
state holds ``torso_occ`` is a torso checkpoint), build the per-video
constants once — the 13-slab k-DOP of the occupied cells, the ray capacity
probed from a few dataset poses, the packed occupancy blocks, the dense
grid views and, for the torso, its occupancy mask over the screen — then
render every frame through the culled renderer (the lattice march and the
compaction, or under ``mean_samples_per_ray: 0`` — the GeneFace import
config's — the walk and the padded slab), and the torso under the head over
the plain background. The grids run in the config's ``grid_backend``.
:meth:`RADNeRFInfer.render_frames` returns uint8 frames;
:meth:`RADNeRFInfer.render_video` muxes them with :func:`save_mp4`.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np
import torch

from geneface_tpu_torch import parallel, resolve_device
from geneface_tpu_torch.convert import flax_to_state_dict
from geneface_tpu_torch.data.radnerf_dataset import RADNeRFDataset, get_cond_window
from geneface_tpu_torch.inference.landmark_postprocess import (
    clamp_lm3d_regions,
    ema_smooth_lm3d,
    gaussian_smooth_lm3d,
    get_win_conds,
    lle_project_lm3d,
)
from geneface_tpu_torch.models.radnerf import (
    TorsoOccupancyState,
    kdop_hit,
    model_from_cfg,
    occupancy_view,
    occupied_kdop,
    render_rays_radnerf,
    render_rays_radnerf_torso,
    torso_occupancy_mask,
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
    """Head or head+torso renderer. ``device`` defaults to ``cuda`` (raises
    without a card); ``dtype`` is the head MLPs' compute dtype (bf16, as the
    JAX model's default; the torso MLPs compute in float32)."""

    def __init__(self, cfg, work_dir: str | None = None, device=None,
                 dtype: torch.dtype = torch.bfloat16):
        self.cfg = cfg
        self.device = resolve_device(device)
        work_dir = work_dir or cfg.get("work_dir")
        path = get_last_checkpoint(work_dir)
        if path is None:
            raise FileNotFoundError(f"no model_ckpt_steps_*.ckpt under {work_dir}")
        state = load_checkpoint(path)["state"]
        self.torso = "torso_occ" in state
        self.model = model_from_cfg(cfg, torso=self.torso, dtype=dtype)
        sd = {k: torch.from_numpy(v) for k, v in flax_to_state_dict(state["params"]).items()}
        self.model.load_state_dict(sd)
        self.model.to(self.device).eval()
        self.occ_grid = torch.tensor(np.asarray(state["occ"][1]), device=self.device)
        self.torso_occ = TorsoOccupancyState(*[
            torch.tensor(np.asarray(x), dtype=torch.float32, device=self.device)
            for x in state["torso_occ"]
        ]) if self.torso else None

        data_dir = cfg.get("data_dir") or (
            f"{cfg.get('binary_data_dir', 'data/binary/videos')}/{cfg.get('video_id', '')}"
        )
        self.dataset = RADNeRFDataset("trainval", data_dir, cfg)
        # 0 for either: the walk (with compaction while mean_samples_per_ray
        # is set, else the padded slab), as the JAX renderer dispatches
        mspr = float(cfg.get("infer_mean_samples_per_ray", cfg.get("mean_samples_per_ray", 8)) or 0)
        lattice_K = int(cfg.get("infer_lattice_K", cfg.get("lattice_K", 48)) or 0)
        self.render_kwargs = dict(
            bound=float(cfg.get("bound", 1)),
            min_near=float(cfg.get("min_near", 0.05)),
            dt_gamma=float(cfg.get("dt_gamma", 1.0 / 256)),
            max_steps=int(cfg.get("max_steps", 16)),
            T_thresh=float(cfg.get("infer_T_thresh", 1e-4)),
            grid_size=int(cfg.get("grid_size", 128)),
            mean_samples_per_ray=mspr or None,
            lattice_K=lattice_K or None,
        )
        self.ray_capacity = None
        self.cull_kdop = None
        self._occ_view = None
        self._tables = None
        self._torso_tables = None
        self.torso_mask = None  # [H*W] bool, per video
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
        """Raw idexp lm3d [T, 68, 3] → normalized cond windows [T, W, 204]:
        normalize, clamp, LLE (``infer_lm3d_lle_percent > 0``), EMA,
        Gaussian, windows."""
        cfg = self.cfg
        mean = np.asarray(self.dataset.idexp_lm3d_mean)
        std = np.asarray(self.dataset.idexp_lm3d_std)
        lm = (idexp_lm3d.reshape(-1, 68, 3) - mean) / std
        lm = clamp_lm3d_regions(lm, cfg.get("infer_lm3d_clamp_std", 2.5))
        lle_percent = cfg.get("infer_lm3d_lle_percent", 0.0)
        # LLE toward the video's own (first-window) conditions; conditions
        # that are not landmark windows skip it, as in the JAX package
        if lle_percent > 0 and self.dataset.conds.ndim == 3:
            db = self.dataset.conds[:, 0].reshape(-1, 68, 3)
            lm = lle_project_lm3d(lm, db, lle_percent, device=self.device)
        lm = ema_smooth_lm3d(lm)
        lm = gaussian_smooth_lm3d(lm, cfg.get("infer_lm3d_smooth_sigma", 0.0))
        flat = lm.reshape(-1, 204).astype(np.float32)
        W = cfg.get("cond_win_size", 1)
        return np.stack([get_win_conds(flat, i, W, "edge") for i in range(len(flat))])

    def prepare(self) -> None:
        """Per-video constants: ray capacity + k-DOP, occupancy blocks, grid
        views; for the torso its grid views and its occupancy mask over the
        dataset's screen coordinates."""
        self.ray_capacity = self._pick_ray_capacity()
        if self.ray_capacity is None:
            self.cull_kdop = None
        self._occ_view = occupancy_view(self.occ_grid, self.render_kwargs["bound"])
        with torch.inference_mode():
            self._tables = self.model.grid_tables()
            if self.torso:
                self._torso_tables = self.model.torso_grid_tables()
                self.torso_mask = torso_occupancy_mask(
                    self.torso_occ,
                    torch.as_tensor(self.dataset.bg_coords, device=self.device),
                    self.render_kwargs["grid_size"],
                    float(self.cfg.get("density_thresh_torso", 0.01)),
                )

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

        rays = (torch.as_tensor(item["rays_o"], device=dev),
                torch.as_tensor(item["rays_d"], device=dev))
        cull = dict(ray_capacity=self.ray_capacity, cull_kdop=self.cull_kdop)
        if not self.torso:
            out = render_rays_radnerf(
                field_fn, *rays, self._occ_view,
                bg_color=torch.as_tensor(item["bg_torso_img"], device=dev),
                **cull, **self.render_kwargs,
            )
            self.last_render = out
            return out
        pose6 = torch.as_tensor(item["pose"], device=dev)
        t_codes = model.torso_individual_codes
        t_ind = t_codes[0] if t_codes is not None else None

        def torso_fn(xy, head_rgb, head_ws):
            return model.forward_torso(xy, pose6, t_ind, head_rgb, head_ws, self._torso_tables)

        out = render_rays_radnerf_torso(
            field_fn, torso_fn, *rays,
            torch.as_tensor(item["bg_coords"], device=dev), self._occ_view, self.torso_occ,
            density_thresh_torso=float(self.cfg.get("density_thresh_torso", 0.01)),
            bg_color=torch.as_tensor(item["bg_img"], device=dev),
            torso_mask=self.torso_mask, **cull, **self.render_kwargs,
        )
        self.last_render = out
        return out

    def render_frames(self, n_frames: int | None = None,
                      idexp_lm3d: np.ndarray | None = None, mesh=None) -> np.ndarray:
        """Render frames driven by ``idexp_lm3d`` (or the dataset's own
        conditions) over the dataset poses (looped) → uint8 [T, H, W, 3].
        With a ``mesh`` the frames split over its data axis (the JAX
        renderer's frame sharding): in each group of ``n`` frames rank
        ``k`` renders frame ``lo + k``, the last group padded with the last
        frame, and a slot all-reduce brings every frame to every rank."""
        ds = self.dataset
        conds = self.conds_from_lm3d(idexp_lm3d) if idexp_lm3d is not None else ds.conds
        self.prepare()
        T = n_frames or len(conds)
        n, r = parallel.data_size(mesh), parallel.data_rank(mesh)
        frames = []
        for lo in range(0, T, n):
            rgb = self.render_frame(min(lo + r, T - 1), conds)["rgb_map"]
            group = parallel.all_gather_slots(mesh, rgb.float().reshape(ds.H, ds.W, 3))
            frames.extend(_to_u8(group[k]) for k in range(min(n, T - lo)))
        return np.stack(frames)

    def render_video(self, idexp_lm3d: np.ndarray | None = None,
                     out_path: str = "infer_out/pred_video/out.mp4",
                     audio_path: str | None = None,
                     n_frames: int | None = None,
                     frame_parallel: bool | None = None) -> str:
        """Render frames, then mux them (and the audio) into an mp4.
        ``frame_parallel`` (default: on when the process group has more
        than one rank and there are at least as many frames) splits the
        frames over the ranks (:meth:`render_frames` with a mesh). In a
        process group rank 0 alone writes the mp4; every rank returns its
        path."""
        world = parallel.world_size()
        if frame_parallel is None:
            T = n_frames or (len(idexp_lm3d) if idexp_lm3d is not None else len(self.dataset.conds))
            frame_parallel = world > 1 and T >= world
        frames = self.render_frames(n_frames, idexp_lm3d,
                                    mesh=parallel.make_mesh() if frame_parallel else None)
        if parallel.rank() != 0:
            return out_path
        return save_mp4(frames, out_path, audio_path=audio_path)


def _to_u8(rgb: torch.Tensor) -> np.ndarray:
    return (rgb.clamp(0.0, 1.0) * 255).to(torch.uint8).cpu().numpy()
