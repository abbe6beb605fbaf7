"""Video traffic: offline speech-to-video rendering as ``render_video`` does
it, without the mp4 mux. Each request is a clip, ``RADNeRFInfer.render_frames
(n, idexp_lm3d)`` of a landmark sequence — the dataset's landmarks plus
seeded motion, standing in for the post-net's output — so that each clip
pays its per-video ``prepare()``. The clip lengths are the mix's list in an
order drawn from the seed; clips start back to back while the clock is
under ``--seconds``, the last one finishes, and ``video_frame_ms`` is the
whole window over every frame delivered.

For the check the float frame behind one frame of each clip (its position
drawn from the seed) is kept, with the clip's landmarks.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch
from torch.profiler import record_function

from pbcore import scene
from reference import serving as rs


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.torso = "head_model_dir" in cfg

    def setup(self) -> None:
        from geneface_tpu_torch.inference import RADNeRFInfer

        cfg, dev = self.cfg, self.device
        work = os.path.join(tempfile.gettempdir(), f"perfbench_{'torso' if self.torso else 'head'}_ckpt")
        self.rcfg = scene.run_cfg(cfg, self.seed, work, scene.dataset_dir(cfg))
        self.P = scene.make_weights(cfg, self.seed, dev, self.torso)
        scene.write_checkpoint(work, self.P, cfg, self.torso)
        self.infer = RADNeRFInfer(self.rcfg, device=dev)
        rng = np.random.RandomState(self.seed % 2**32)
        ds = scene.read_dataset(cfg)
        lm = np.stack([np.asarray(s["idexp_lm3d_normalized_win"], np.float32).reshape(68, 3)
                       for s in ds["train_samples"] + ds["val_samples"]])
        self.lm_base = lm * np.asarray(ds["idexp_lm3d_std"]) + np.asarray(ds["idexp_lm3d_mean"])
        self.lm_std = np.asarray(ds["idexp_lm3d_std"], np.float32)
        self.lengths = [int(x) for x in rng.permutation(self.mix["clip_frames"])]
        self.rng = rng
        # warm-up: one short clip (prepare, the frame path, the uint8 copy)
        self.infer.render_frames(2, self.clip_lm3d(int(self.mix["warm_frames"])))
        self.kept = []

    def clip_lm3d(self, n: int) -> np.ndarray:
        """``n`` frames of landmarks: the dataset's, cycled from a seeded
        start, plus seeded motion of ``motion_std`` of the landmarks' spread."""
        start = self.rng.randint(len(self.lm_base))
        base = self.lm_base[(start + np.arange(n)) % len(self.lm_base)]
        noise = self.rng.randn(*base.shape).astype(np.float32)
        return (base + float(self.mix["motion_std"]) * self.lm_std * noise).astype(np.float32)

    def window(self, seconds: float, traced: bool) -> dict:
        infer = self.infer
        frames, clips, k = 0, 0, 0
        self.clip_lengths = []  # of every clip, for the counts
        real_render = infer.render_frame
        real_prepare = infer.prepare

        def prepare():
            with record_function("pb::prepare"):
                real_prepare()

        infer.prepare = prepare
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            n = self.lengths[k % len(self.lengths)]
            k += 1
            lm3d = self.clip_lm3d(n)
            keep_at = int(self.rng.randint(n))
            kept = {}

            def render(i, conds=None, _keep=keep_at, _kept=kept):
                out = real_render(i, conds)
                if i == _keep:
                    _kept["rgb"] = out["rgb_map"].detach().clone()
                return out

            infer.render_frame = render
            out = infer.render_frames(n, lm3d)
            self.kept.append((lm3d, keep_at, kept["rgb"], out[keep_at]))
            self.clip_lengths.append(n)
            frames += len(out)
            clips += 1
        wall = time.perf_counter() - t0
        infer.render_frame, infer.prepare = real_render, real_prepare
        return {"end_to_end": {"video_frame_ms": wall / frames * 1e3},
                "attempted": frames, "failed": 0, "frames": frames, "clips": clips, "wall_s": wall}

    def release(self) -> None:
        del self.infer
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits: dict) -> list:
        gaps = rs.check_video(self.cfg, self.rcfg, self.P, self.kept, self.device)
        return [{"name": k, "value": v, "limit": limits.get(k)} for k, v in gaps.items()]

    def flops(self) -> tuple:
        return rs.video_flops(self.cfg, self.rcfg, self.clip_lengths, self.device), 0.0
