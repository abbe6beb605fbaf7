"""Training traffic: what ``Trainer.fit``'s inner loop drives,
``task.train_step(next(task.train_batches(step)))``, on the RAD-NeRF head
(``RADNeRFTask``) or, for a configuration with ``head_model_dir``, the torso
on the frozen head (``RADNeRFTorsoTask``).

Set-up builds the task from the run's configuration, loads the seed's
weights and the planted occupancy (the head a trained one; the torso's head
from a checkpoint, as a user's torso run loads its trained head), and drives
the task through its first ``first_steps`` steps through the window's own
call and feed (the reference follows them), then ``warm_steps`` more; the
window goes on with that same task. The window reads the losses every
``tb_log_interval`` steps, as ``Trainer.fit`` logs them, and synchronizes
once at its end: ``train_rays_per_s`` is every ray of every step over the
whole window.

The reference follows the window's first ``check_steps`` steps too, from
the state the task held when the window opened (its parameters, Adam's
moments, its occupancy), which set-up keeps. ``warm_steps`` ends set-up on
a sweep step, so the window's first step sweeps. After the window, the
torso's frozen head is compared with the seed's weights.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import record_function

from pbcore import scene
from reference import training as rt


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.torso = "head_model_dir" in cfg

    # ---------------------------------------------------------------- set-up
    def setup(self) -> None:
        from geneface_tpu_torch.models.radnerf import OccupancyState
        from geneface_tpu_torch.tasks.radnerf import RADNeRFTask
        from geneface_tpu_torch.tasks.radnerf_torso import RADNeRFTorsoTask

        cfg, dev = self.cfg, self.device
        work = os.path.join(tempfile.gettempdir(), "perfbench_train_work")
        self.rcfg = scene.run_cfg(cfg, self.seed, work, scene.dataset_dir(cfg))
        P = scene.make_weights(cfg, self.seed, dev, self.torso)
        self.P0 = {k: v.clone() for k, v in P.items()}
        if self.torso:  # the trained head, as a torso run loads it
            head_dir = os.path.join(work, "head")
            os.makedirs(head_dir, exist_ok=True)
            scene.write_checkpoint(head_dir, P, cfg, torso=False)
            self.rcfg["head_model_dir"] = head_dir
        task = (RADNeRFTorsoTask if self.torso else RADNeRFTask)(self.rcfg, device=dev)
        task.build()
        task.model.load_state_dict(P, strict=True)
        del P
        density, occ, mean = scene.planted_occupancy(int(cfg["grid_size"]), float(cfg["density_thresh"]))
        task.set_occupancy(OccupancyState(torch.as_tensor(density, device=dev),
                                          torch.as_tensor(occ, device=dev),
                                          torch.as_tensor(mean, device=dev)))
        self.task = task
        self.names = {p: n for n, p in task.model.named_parameters()}
        self.batches = task.train_batches(0)
        self.first_batches, self.first_losses = [], []
        for k in range(int(self.mix["first_steps"])):
            batch = next(self.batches)
            self.first_batches.append(batch)
            out = task.train_step(batch)
            self.first_losses.append(float(out["total_loss"]))
            if k == 0:
                opt = task.optimizer
                # the first moment after one step (none: the step held nothing)
                self.mu1 = {self.names[p]: self.moment(p, "mu")
                            for g in opt.param_groups for p in g["params"]}
        self.theta3 = {n: p.detach().clone() for n, p in task.model.named_parameters()
                       if p.requires_grad}
        for _ in range(int(self.mix["warm_steps"])):
            float(task.train_step(next(self.batches))["total_loss"])
        self.start = self.state()

    def moment(self, p, key: str):
        """Adam's moment of ``p`` (zeros where its step has held nothing)."""
        return self.task.optimizer.state[p].get(key, torch.zeros_like(p)).clone()

    def state(self) -> dict:
        """What the reference starts the window's steps from: the step, the
        parameters, Adam's moments, the occupancy and the buckets."""
        task, opt = self.task, self.task.optimizer
        trained = [p for g in opt.param_groups for p in g["params"]]
        occ = task.torso_occ if self.torso else task.occ
        return {"k0": task._step,
                "theta": {n: p.detach().clone() for n, p in task.model.named_parameters()},
                "mu": {self.names[p]: self.moment(p, "mu") for p in trained},
                "nu": {self.names[p]: self.moment(p, "nu") for p in trained},
                "occ": tuple(x.clone() for x in (occ if self.torso else
                                                 (occ.density_grid, occ.occ_grid, occ.mean_density))),
                "latk": int(getattr(task, "_latk_bucket", None) or self.cfg["lattice_K"]),
                "spr": float(getattr(task, "_spr_bucket", None) or self.cfg["mean_samples_per_ray"])}

    # ---------------------------------------------------------------- window
    def window(self, seconds: float, traced: bool) -> dict:
        task, log = self.task, int(self.cfg["tb_log_interval"])
        self.steps_seen = []  # (step, frame idx, inds) of each step, traced only
        self.occ_at = {}  # step → the occupancy the model holds from then on
        if traced and not self.torso:
            self.occ_at[task._step] = task.occ.occ_grid.clone()
        n_check = int(self.mix["check_steps"])
        self.window_batches, self.window_losses = [], []
        trained = [p for g in task.optimizer.param_groups for p in g["params"]]
        steps, bad = 0, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or steps < n_check:
            with record_function("pb::data_wait"):
                batch = next(self.batches)
            step = task._step
            out = task.train_step(batch)
            if steps < n_check:  # kept for the reference, read after the window
                self.window_batches.append(batch)
                self.window_losses.append(out["total_loss"])
                if steps == 0:
                    self.mu_window = {self.names[p]: self.moment(p, "mu") for p in trained}
                if steps == n_check - 1:
                    self.theta_window = {self.names[p]: p.detach().clone() for p in trained}
            if traced:
                self.steps_seen.append((step, int(batch["idx"]), batch["inds"]))
                if out["occupancy_sweep"] and not self.torso:
                    self.occ_at[step] = task.occ.occ_grid.clone()
            steps += 1
            if steps % log == 0:
                bad += not np.isfinite(float(out["total_loss"]))
        torch.cuda.synchronize(self.device) if self.device.type == "cuda" else None
        wall = time.perf_counter() - t0
        self.window_losses = [float(x) for x in self.window_losses]
        if self.torso:  # the frozen head, every leaf of it, against the seed's weights
            gaps = [float((p.detach() - self.P0[n]).abs().max())
                    for n, p in task.model.named_parameters() if n not in self.theta3]
            self.head_gap = max(gaps)
        n_rays = int(self.cfg["n_rays"])
        return {"end_to_end": {"train_rays_per_s": steps * n_rays / wall},
                "attempted": steps, "failed": bad, "steps": steps, "wall_s": wall}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.task.train_ds.native_loader = None
        del self.task, self.batches
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ----------------------------------------------------------------- check
    def check(self, limits: dict, half: bool = False) -> list:
        """The run's first steps from the seed's weights, then the window's
        first steps from the state the window opened on."""
        b1 = float(self.cfg["optimizer_adam_beta1"])
        got = rt.replay(self.cfg, self.rcfg, self.P0, self.first_batches, self.device, self.torso,
                        half=half)
        detail = {}
        nums = rt.compare(got, self.first_losses, {n: m / (1.0 - b1) for n, m in self.mu1.items()},
                          self.theta3, self.P0, detail=detail)
        st = dict(self.start, latk=got["latk"], spr=got["spr"])
        won = rt.replay(self.cfg, self.rcfg, None, self.window_batches, self.device, self.torso,
                        half=half, start=st)
        # the gradient that the window's first update folded into the moment
        g_win = {n: (self.mu_window[n] - b1 * st["mu"][n]) / (1.0 - b1) for n in self.mu_window}
        nums.update(rt.compare(won, self.window_losses, g_win, self.theta_window, st["theta"],
                               prefix="window_", detail=detail))
        # each step's loss gap and the worst leaves, read where a number nears its limit
        print(f"check detail{' (half a batch)' if half else ''}: {json.dumps(detail)}",
              file=sys.stderr)
        nums["batch_pixel_levels"] = float(max(got["pixel_levels"], won["pixel_levels"], 1) - 1)
        if self.torso:
            nums["head_frozen_gap"] = self.head_gap
        return [{"name": k, "value": v, "limit": limits.get(k)} for k, v in nums.items()]

    def fault_readings(self) -> dict:
        """The numbers with a fault planted in the reference in the
        program's place: half of each batch left out of the loss."""
        return {"half_batch": {c["name"]: c["value"] for c in self.check({}, half=True)}}

    # ---------------------------------------------------------------- counts
    def flops(self) -> tuple:
        """(bfloat16, float32) matrix operations of the window's steps: the
        samples that each step's rays need, by the reference's march of that
        step's rays and jitter over the occupancy the model held."""
        return rt.window_flops(self.cfg, self.rcfg, self.steps_seen, self.occ_at,
                               self.device, self.torso)
