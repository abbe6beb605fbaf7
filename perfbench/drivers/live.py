"""Live traffic: the real-time viewer's per-frame request, closed loop, one
client. Each frame is ``RealtimeRenderer.render(cam)`` at a fixed rung
(``downscale_override``, the ladder off) after the ``OrbitCamera`` has been
orbited by a seeded small delta and the condition index advanced, as a user
dragging the view while the talk plays. A request is timed from the call to
the uint8 frame on the host, the host's inputs included; the HTTP round trip
and the JPEG are not part of it.

For the check the float frame of every ``keep_every``-th frame (from a
seeded offset) is kept with its condition index; the camera's deltas are
recorded so that the reference can pose the camera itself.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch
from torch.profiler import record_function

from pbcore import readers, scene
from reference import serving as rs


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.torso = "head_model_dir" in cfg

    def setup(self) -> None:
        from geneface_tpu_torch.inference import RADNeRFInfer
        from geneface_tpu_torch.inference.gui import OrbitCamera, RealtimeRenderer

        cfg, dev = self.cfg, self.device
        work = os.path.join(tempfile.gettempdir(), f"perfbench_{'torso' if self.torso else 'head'}_ckpt")
        self.rcfg = scene.run_cfg(cfg, self.seed, work, scene.dataset_dir(cfg))
        self.P = scene.make_weights(cfg, self.seed, dev, self.torso)
        scene.write_checkpoint(work, self.P, cfg, self.torso)
        infer = RADNeRFInfer(self.rcfg, device=dev)
        r = RealtimeRenderer(infer, dynamic_resolution=False)
        r.downscale_override = float(self.mix["downscale"])
        real_inputs = r.inputs

        def inputs(cam, cond_wins_all=None):
            with record_function("pb::inputs"):
                return real_inputs(cam, cond_wins_all)

        r.inputs = inputs
        ds = infer.dataset
        cam = OrbitCamera(ds.W, ds.H)
        cam.update_intrinsics(ds.intrinsics)
        cam.update_pose(np.asarray(ds.poses[0]))
        self.infer, self.renderer, self.cam = infer, r, cam
        self.rng = np.random.RandomState(self.seed % 2**32)
        self.deltas = []  # every orbit applied, warm-up included
        for _ in range(int(self.mix["warm_frames"])):
            self.request()

    def request(self) -> np.ndarray:
        step = float(self.mix["orbit_step"])
        dx, dy = (float(v) for v in self.rng.uniform(-step, step, 2))
        self.cam.orbit(dx, dy)
        self.deltas.append((dx, dy))
        self.renderer.cond_index += 1
        return self.renderer.render(self.cam)

    def window(self, seconds: float, traced: bool) -> dict:
        every = int(self.mix["keep_every"])
        offset = int(self.rng.randint(every))
        lat, self.kept = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            ts = time.perf_counter()
            frame = self.request()
            lat.append(time.perf_counter() - ts)
            if len(lat) % every == offset:
                self.keep(frame)
        wall = time.perf_counter() - t0
        if not self.kept or self.kept[-1][0] != len(self.deltas):
            self.keep(frame)  # the window's last frame
        self.frames = len(lat)
        p95 = readers.p95_ms(lat)
        return {"end_to_end": {"live_frame_ms": wall / len(lat) * 1e3, "live_frame_p95_ms": p95},
                "attempted": len(lat), "failed": 0, "frames": len(lat), "wall_s": wall,
                "latencies_s": lat}

    def keep(self, frame) -> None:
        self.kept.append((len(self.deltas), self.renderer.cond_index,
                          self.infer.last_render["rgb_map"].detach().clone(), frame))

    def release(self) -> None:
        del self.renderer, self.infer
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits: dict) -> list:
        gaps = rs.check_live(self.cfg, self.rcfg, self.P, self.deltas, self.kept,
                             float(self.mix["downscale"]), self.device)
        return [{"name": k, "value": v, "limit": limits.get(k)} for k, v in gaps.items()]

    def flops(self) -> tuple:
        return rs.live_flops(self.cfg, self.rcfg, self.deltas, self.frames,
                             float(self.mix["downscale"]), self.device)
