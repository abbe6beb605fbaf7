"""Vanilla NeRF inference: checkpoint + conditions → frames → mp4 (port of
``geneface_tpu/inference/nerf_infer.py``).

:class:`BaseVanillaNeRFInfer` loads the newest checkpoint of the work dir
(and, with ``head_model_dir``, the frozen head's: then the work dir holds
the torso), and renders every frame at its dataset pose over all pixels
(``infer_scale_factor`` scales the grid) through the coarse and fine
passes, without jitter, in chunks of ``max_ray_batch`` rays (4,096 by
default; the last one padded with its edge row). Head rays are at the
frame's pose, torso rays at the canonical ``c2w_t0``, and the frame is the
head over the torso, ``head · last_weight_torso + rgb_fg_torso``. The
frame's rays stay on the device and its pixels come back in one copy.

:class:`LM3dNeRFInfer` cleans a predicted lm3d first (region clamp, the LLE
projection, blinks from the ground truth, a closed mouth on silence, a
temporal Gaussian); :class:`ADNeRFInfer` takes ``[T, 16, 29]`` DeepSpeech
windows as they are. :meth:`~BaseVanillaNeRFInfer.render_video` muxes the
frames with :func:`~geneface_tpu_torch.inference.radnerf_infer.save_mp4`.

The torso's pose condition is the frame's ``[3]`` euler and translation, as
in training: the JAX renderer passes ``[1, 3]`` slices there, which its torso
model cannot broadcast.
"""

from __future__ import annotations

import numpy as np
import torch

from geneface_tpu_torch import resolve_device
from geneface_tpu_torch.data.nerf_dataset import NeRFDataset
from geneface_tpu_torch.data.radnerf_dataset import get_cond_window
from geneface_tpu_torch.inference.landmark_postprocess import (
    clamp_lm3d_regions,
    close_mouth_when_silent,
    gaussian_smooth_lm3d,
    get_win_conds,
    inject_blinks_from_gt,
    lle_project_lm3d,
)
from geneface_tpu_torch.inference.radnerf_infer import save_mp4
from geneface_tpu_torch.ops.volume import render_rays
from geneface_tpu_torch.utils.checkpoint import get_last_checkpoint, load_checkpoint

__all__ = ["BaseVanillaNeRFInfer", "LM3dNeRFInfer", "ADNeRFInfer"]


def _checkpoint_params(work_dir: str) -> dict:
    path = get_last_checkpoint(work_dir)
    if path is None:
        raise FileNotFoundError(f"no model_ckpt_steps_*.ckpt under {work_dir}")
    return load_checkpoint(path)["state"]["params"]


class BaseVanillaNeRFInfer:
    """Checkpoint and dataset loading and the chunked frame render;
    ``device`` defaults to ``cuda`` (raises without a card)."""

    def task_class(self):
        """The task whose ``make_model`` (and ``make_torso_model``) build
        the models: the torso task when ``head_model_dir`` is set."""
        raise NotImplementedError

    def __init__(self, cfg, work_dir: str | None = None, device=None):
        from geneface_tpu_torch.tasks.lm3d_nerf import load_nerf_params

        self.cfg = cfg
        self.device = resolve_device(device)
        params = _checkpoint_params(work_dir or cfg.get("work_dir"))
        task = self.task_class()(cfg, device=self.device)
        self.torso = hasattr(task, "make_torso_model")
        self.model = task.make_model()
        if self.torso:
            load_nerf_params(self.model, _checkpoint_params(cfg.get("head_model_dir")))
            self.torso_model = task.make_torso_model()
            load_nerf_params(self.torso_model, params)
            self.torso_model.to(self.device).eval()
            self.use_color = task.use_color()
        else:
            self.torso_model = None
            load_nerf_params(self.model, params)
        self.model.to(self.device).eval()

        data_dir = cfg.get("data_dir") or (
            f"{cfg.get('binary_data_dir', 'data/binary/videos')}/{cfg.get('video_id', '')}")
        self.dataset = NeRFDataset("trainval", data_dir, cfg, training=False)
        self.chunk = int(cfg.get("max_ray_batch", 4096))
        self.render_kwargs = dict(
            near=cfg.get("near", 0.3), far=cfg.get("far", 0.9),
            n_samples=int(cfg.get("n_samples_per_ray", 64)),
            n_importance=int(cfg.get("n_samples_per_ray_fine", 128)),
        )
        self.with_att = bool(cfg.get("with_att", True))

    # -- conditions (per subclass) -------------------------------------------
    def get_conds(self, *args, **kwargs) -> np.ndarray:
        """→ per-frame conditions, indexable by ``get_cond_window``."""
        raise NotImplementedError

    # -- render ---------------------------------------------------------------
    def frame_inputs(self, frame_idx: int, conds: np.ndarray) -> dict:
        """Rays, background and conditions of frame ``frame_idx`` (at the
        dataset pose ``frame_idx % len(dataset)``), on the device."""
        ds = self.dataset
        i = frame_idx % len(ds)
        item = ds[i]
        rays = [item["rays_o"], item["rays_d"]]
        if self.torso:
            ro_t, rd_t, _ = ds.full_sampler(ds.H, ds.W, ds.focal, ds.c2w_t0, cx=ds.cx, cy=ds.cy)
            rays += [ro_t, rd_t]
        dev = self.device

        def put(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        smo = self.cfg.get("smo_win_size", 5)
        return {
            "rays": [put(a) for a in rays], "bg": put(item["bg_img"]),
            "cond_wins": put(get_cond_window(conds, frame_idx, smo)),
            "cond1": put(conds[min(frame_idx, len(conds) - 1)][None]),
            "euler": put(ds.eulers[i]), "trans": put(ds.transs[i]),
        }

    def render_chunk(self, rays: list, bg: torch.Tensor, head_feat: torch.Tensor,
                     cond_wins: torch.Tensor, euler: torch.Tensor,
                     trans: torch.Tensor, z_samples: tuple | None = None) -> tuple:
        """One chunk → (rgb ``[C, 3]``, the fine importance samples of the
        head and the torso). ``z_samples`` replays given importance samples
        (a card render's, on the CPU)."""
        zh, zt = z_samples or (None, None)
        ro, rd = rays[0], rays[1]
        vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
        head = self.model
        head_out = render_rays(lambda pts, fine: head(pts, head_feat, vd, fine), ro, rd,
                               bc_rgb=bg, z_samples=zh, **self.render_kwargs)
        if not self.torso:
            return head_out["rgb_map"], (head_out.get("z_samples"), None)
        torso = self.torso_model
        ro_t, rd_t = rays[2], rays[3]
        vd_t = rd_t / torch.linalg.norm(rd_t, dim=-1, keepdim=True)
        feat = torso.cal_cond_feat(cond_wins, euler, trans,
                                   color=head_out["rgb_map"] if self.use_color else None,
                                   with_att=True)
        torso_out = render_rays(lambda pts, fine: torso(pts, feat, vd_t, fine), ro_t, rd_t,
                                bc_rgb=bg, z_samples=zt, **self.render_kwargs)
        rgb = head_out["rgb_map"] * torso_out["last_weight"][:, None] + torso_out["rgb_map_fg"]
        return rgb, (head_out.get("z_samples"), torso_out.get("z_samples"))

    @torch.no_grad()
    def render_frame(self, frame_idx: int, conds: np.ndarray) -> np.ndarray:
        """Frame ``frame_idx`` over all its pixels → float ``[h, w, 3]``."""
        x = self.frame_inputs(frame_idx, conds)
        head_feat = self.model.cal_cond_feat(
            x["cond_wins"] if self.with_att else x["cond1"], self.with_att)
        rays, bg = x["rays"], x["bg"]
        N, C = bg.shape[0], self.chunk
        pad = -N % C
        if pad:  # the last chunk repeats its edge row
            rays = [torch.cat([a, a[-1:].expand(pad, 3)]) for a in rays]
            bg = torch.cat([bg, bg[-1:].expand(pad, 3)])
        out = torch.empty(N + pad, 3, device=self.device)
        for lo in range(0, N + pad, C):
            sl = slice(lo, lo + C)
            out[sl] = self.render_chunk([a[sl] for a in rays], bg[sl], head_feat,
                                        x["cond_wins"], x["euler"], x["trans"])[0]
        ds = self.dataset
        side_h = int(round(ds.H * float(self.cfg.get("infer_scale_factor", 1.0))))
        return out[:N].cpu().numpy().reshape(side_h, N // max(side_h, 1), 3)

    def render_video(self, conds: np.ndarray, out_path: str = "infer_out/pred_video/out.mp4",
                     audio_path: str | None = None, n_frames: int | None = None) -> str:
        frames = [(np.clip(self.render_frame(i, conds), 0, 1) * 255).astype(np.uint8)
                  for i in range(n_frames or len(conds))]
        return save_mp4(np.stack(frames), out_path, audio_path=audio_path)


class LM3dNeRFInfer(BaseVanillaNeRFInfer):
    """Landmark-conditioned frames from a predicted lm3d."""

    def task_class(self):
        from geneface_tpu_torch.tasks.lm3d_nerf import Lm3dNeRFTask, Lm3dNeRFTorsoTask

        return Lm3dNeRFTorsoTask if self.cfg.get("head_model_dir") else Lm3dNeRFTask

    def get_conds(self, idexp_lm3d: np.ndarray, wav_path: str | None = None) -> np.ndarray:
        """Raw predicted idexp lm3d ``[T, 68, 3]`` → per-frame windows
        ``[T, cond_win_size, 204]``: normalized by the dataset's mean and
        std, clamped per region, LLE-projected (``infer_lm3d_lle_percent``),
        blinks (``infer_inject_eye_blink_mode``), the mouth closed on silence
        (``infer_close_mouth_when_sil``, with ``wav_path``) and smoothed
        (``infer_lm3d_smooth_sigma``). As in the JAX renderer, the silence
        test reads the mel transposed (``[80, T]``)."""
        cfg = self.cfg
        ds = self.dataset
        db = np.asarray(ds.conds[:, 0]).reshape(-1, 68, 3)
        lm = idexp_lm3d.reshape(-1, 68, 3).astype(np.float32)
        if ds.idexp_lm3d_mean is not None and ds.idexp_lm3d_std is not None:
            lm = (lm - np.asarray(ds.idexp_lm3d_mean)) / np.asarray(ds.idexp_lm3d_std)
        lm = clamp_lm3d_regions(lm, cfg.get("infer_lm3d_clamp_std", 2.5))
        lle_percent = cfg.get("infer_lm3d_lle_percent", 0.0)
        if lle_percent > 0:
            lm = lle_project_lm3d(lm, db, lle_percent, device=self.device)
        lm = inject_blinks_from_gt(
            lm, db, mode=cfg.get("infer_inject_eye_blink_mode", "none"),
            ref_start=cfg.get("infer_eye_blink_ref_frames_start_idx"),
            ref_end=cfg.get("infer_eye_blink_ref_frames_end_idx"),
        )
        if cfg.get("infer_close_mouth_when_sil", False) and wav_path:
            from geneface_tpu_torch.utils.audio import load_wav16k, melspectrogram

            mel = melspectrogram(load_wav16k(wav_path)).T
            lm = close_mouth_when_silent(lm, mel, db[int(cfg.get("infer_sil_ref_frame_idx", 0))])
        lm = gaussian_smooth_lm3d(lm, cfg.get("infer_lm3d_smooth_sigma", 0.0))
        flat = lm.reshape(-1, 204).astype(np.float32)
        W = cfg.get("cond_win_size", 1)
        return np.stack([get_win_conds(flat, i, W, "edge") for i in range(len(flat))])

    def run(self, pred_lm3d_npy: str, out_path: str, audio_path: str | None = None,
            n_frames: int | None = None) -> str:
        """A predicted lm3d ``.npy`` → the mp4 → its path."""
        lm3d = np.load(pred_lm3d_npy).reshape(-1, 68, 3)
        conds = self.get_conds(lm3d, wav_path=audio_path)
        return self.render_video(conds, out_path, audio_path=audio_path, n_frames=n_frames)


class ADNeRFInfer(BaseVanillaNeRFInfer):
    """DeepSpeech-conditioned frames: ``[T, 16, 29]`` windows as they are."""

    def task_class(self):
        from geneface_tpu_torch.tasks.lm3d_nerf import ADNeRFTask, ADNeRFTorsoTask

        return ADNeRFTorsoTask if self.cfg.get("head_model_dir") else ADNeRFTask

    def get_conds(self, deepspeech_win: np.ndarray) -> np.ndarray:
        return np.asarray(deepspeech_win, np.float32)

    def run(self, deepspeech_npy: str, out_path: str, audio_path: str | None = None,
            n_frames: int | None = None) -> str:
        """A precomputed DeepSpeech ``.npy`` → the mp4 → its path."""
        conds = self.get_conds(np.load(deepspeech_npy))
        return self.render_video(conds, out_path, audio_path=audio_path, n_frames=n_frames)
