"""The reference's served frames: a video frame of a clip, or a viewer
frame of the orbit camera, rendered from the benchmark's weights, the
planted occupancy and the raw dataset file, with every per-video constant
worked out again here (the smoothed camera path, the k-DOP, the ray
capacity probed from the dataset's poses, the grids' views, the torso
mask), and the numbers by which the program's frames depart from it."""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from pbcore.scene import planted_occupancy, planted_torso_occupancy
from reference import radnerf as ref


class ServedPerson:
    """The dataset as a renderer serves it: every frame, the camera path
    smoothed, the landmark statistics."""

    def __init__(self, cfg: dict, rcfg: dict):
        ds = np.load(os.path.join(rcfg["data_dir"], "trainval_dataset.npy"), allow_pickle=True).tolist()
        self.samples = list(ds["train_samples"]) + list(ds["val_samples"])
        self.H, self.W = int(ds["H"]), int(ds["W"])
        self.intr = (float(ds["focal"]), float(ds["focal"]), float(ds["cx"]), float(ds["cy"]))
        self.bg = np.asarray(ds["bg_img"], np.float32) / 255.0
        poses = np.stack([ref.ngp_pose(s["c2w"], float(cfg["camera_scale"])) for s in self.samples])
        self.poses = ref.smooth_path(poses, int(cfg["infer_smooth_camera_path_kernel_size"]))
        self.conds = np.stack([np.asarray(s["idexp_lm3d_normalized_win"], np.float32).reshape(1, 204)
                               for s in self.samples])
        self.mean = np.asarray(ds["idexp_lm3d_mean"])
        self.std = np.asarray(ds["idexp_lm3d_std"])

    def bg_torso(self, i: int) -> np.ndarray:
        t = np.asarray(self.samples[i]["torso_img"], np.float32) / 255.0
        return (t[..., :3] * t[..., 3:] + self.bg * (1 - t[..., 3:])).reshape(-1, 3)


class Scene:
    """The per-video constants and the fields over the benchmark's weights."""

    def __init__(self, cfg, rcfg, P, device, torso, grid_bf16=False):
        ref.set_full_fp32()
        self.cfg, self.device, self.torso = cfg, device, torso
        self.person = ServedPerson(cfg, rcfg)
        H = int(cfg["grid_size"])
        self.occ0 = torch.as_tensor(planted_occupancy(H, float(cfg["density_thresh"]))[1],
                                    device=device)[0]
        self.bound = float(cfg["bound"])
        self.box = ref.kdop(self.occ0, self.bound)
        p = self.person
        n = 0
        for i in list(range(0, len(p.samples), max(1, len(p.samples) // 4)))[:4]:
            o, d = ref.get_rays(p.poses[i], p.intr, p.H, p.W)
            n = max(n, int(ref.kdop_hit(torch.as_tensor(o, device=device), torch.as_tensor(d, device=device),
                                         self.box, float(cfg["min_near"])).sum()))
        self.capacity = ref.ray_capacity(n, p.H * p.W)
        self.head = ref.Head(cfg, P, grid_bf16=grid_bf16)
        self.views = self.head.views()
        self.code = P["individual_embeddings"][0]
        self.kw = dict(bound=self.bound, min_near=float(cfg["min_near"]),
                       max_steps=int(cfg["max_steps"]), grid_size=H,
                       lattice_K=int(cfg["lattice_K"]),
                       mean_samples_per_ray=float(cfg["mean_samples_per_ray"]))
        if torso:
            self.tor = ref.Torso(cfg, P, grid_bf16=grid_bf16)
            self.tviews = self.tor.views()
            self.tcode = P["torso_individual_codes"][0]
            td, tm = planted_torso_occupancy(H)
            self.tdensity = torch.as_tensor(td, device=device)
            self.tmean = torch.as_tensor(tm, device=device)

    @torch.no_grad()
    def frame(self, o, d, cond_win, bg, capacity, coords=None, pose6=None):
        dev = self.device
        cf = self.head.cond(torch.as_tensor(cond_win, device=dev))
        o, d = torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)
        bg = torch.as_tensor(bg, device=dev) if not self.torso else bg
        field = (lambda x, dd: self.head(x, dd, cf, self.code, self.views))
        head = ref.render_frame(field, o, d, self.occ0, self.box, capacity,
                                0.0 if self.torso else bg, **self.kw)
        if not self.torso:
            return head
        coords = torch.as_tensor(coords, device=dev)
        mask = ref.torso_mask(self.tdensity, self.tmean, coords, int(self.cfg["grid_size"]),
                              float(self.cfg["density_thresh_torso"]))
        t_out = self.tor(coords, torch.as_tensor(pose6, device=dev), self.tcode, self.tviews)
        out = ref.torso_composite(head, t_out, mask, torch.as_tensor(bg, device=dev))
        out["valid"] = head["valid"]
        return out

    def count(self, o, d, capacity) -> float:
        """Samples the frame's culled rays need (the march alone)."""
        dev = self.device
        o, d = torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)
        if capacity:
            hit = ref.kdop_hit(o, d, self.box, self.kw["min_near"])
            found = torch.nonzero(hit)[:int(capacity), 0]
            o, d = o[found], d[found]
        nears, fars = ref.near_far(o.float(), d.float(), ref.make_aabb(self.bound, dev), self.kw["min_near"])
        m = ref.march_lattice(o.float(), d.float(), self.occ0, nears, fars,
                              torch.zeros(o.shape[0], device=dev), bound=self.bound,
                              max_steps=self.kw["max_steps"], grid_size=self.kw["grid_size"],
                              lattice_K=self.kw["lattice_K"])
        return float(m.valid.sum())


def _gaps(got_rgb, got_u8, want_rgb, H, W) -> tuple:
    """The float frame's widest gap to the reference, and the largest level
    by which the delivered uint8 frame departs from that float frame's
    truncation (exact: the frame delivered is the frame rendered)."""
    rgb = got_rgb.float().reshape(-1, 3)
    gap = float((rgb - want_rgb).abs().max())
    own = (np.clip(rgb.cpu().numpy(), 0, 1) * 255).astype(np.uint8).astype(np.int16)
    levels = int(np.abs(np.asarray(got_u8).astype(np.int16).reshape(-1, 3) - own).max())
    return gap, levels


def check_video(cfg, rcfg, P, kept, device, grid_bf16=False) -> dict:
    """One frame of each clip: its float frame's widest gap to the
    reference, and its uint8 frame's in levels."""
    sc = Scene(cfg, rcfg, P, device, False, grid_bf16)
    p = sc.person
    smo = int(cfg["smo_win_size"])
    worst_gap, worst_levels = 0.0, 0
    for lm3d, f, rgb, u8 in kept:
        conds = ref.conds_from_lm3d(lm3d, p.mean, p.std, float(cfg["infer_lm3d_clamp_std"]),
                                    int(cfg["cond_win_size"]))
        i = f % len(p.samples)
        o, d = ref.get_rays(p.poses[i], p.intr, p.H, p.W)
        out = sc.frame(o, d, ref.cond_window(conds, f, smo), p.bg_torso(i), sc.capacity)
        g, lv = _gaps(rgb, u8, out["rgb_map"], p.H, p.W)
        worst_gap, worst_levels = max(worst_gap, g), max(worst_levels, lv)
    return {"frame_rgb_gap": worst_gap, "frame_u8_exact": float(worst_levels)}


def video_flops(cfg, rcfg, clip_frames, device) -> float:
    """bfloat16 operations of every frame of the window's clips."""
    from counts import flops as fl

    sc = Scene(cfg, rcfg, _no_params(cfg, device), device, False)
    p = sc.person
    per_pose = {}
    total = 0.0
    for n in clip_frames:
        for f in range(n):
            i = f % len(p.samples)
            if i not in per_pose:
                o, d = ref.get_rays(p.poses[i], p.intr, p.H, p.W)
                per_pose[i] = sc.count(o, d, sc.capacity)
            total += per_pose[i]
    return total * fl.head_sample_flops(cfg)


def _no_params(cfg, device) -> dict:
    """Zero weights: the march and the cull read no weight."""
    from pbcore.scene import param_specs

    return {n: torch.zeros(s, device=device) for n, s, _ in param_specs(cfg, "head_model_dir" in cfg)}


class Camera:
    """The viewer's orbit camera (ngp convention), posed from the dataset's
    first pose and orbited by the recorded deltas."""

    def __init__(self, W, H, intr, pose):
        fl_y, cx, cy = float(intr[1]), float(intr[2]), float(intr[3])
        self.W, self.H = int(cx * 2), int(cy * 2)
        self.fovy = math.degrees(2 * math.atan2(self.H, 2 * fl_y))
        self.radius = float(np.linalg.norm(pose[:3, 3]))
        T = np.eye(4, dtype=np.float32)
        T[2, 3] = -self.radius
        self.rot = (pose @ np.linalg.inv(T))[:3, :3].astype(np.float32)
        self.center = np.zeros(3, np.float32)
        self.up = np.array([1, 0, 0], np.float32)

    @staticmethod
    def _rot(v):
        th = float(np.linalg.norm(v))
        if th < 1e-12:
            return np.eye(3, dtype=np.float32)
        k = v / th
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], np.float32)
        return np.eye(3, dtype=np.float32) + math.sin(th) * K + (1 - math.cos(th)) * (K @ K)

    def orbit(self, dx, dy):
        side = self.rot[:3, 0]
        self.rot = self._rot(self.up * math.radians(-0.01 * dx)) @ self._rot(side * math.radians(-0.01 * dy)) @ self.rot

    @property
    def pose(self):
        res = np.eye(4, dtype=np.float32)
        res[2, 3] -= self.radius
        rot = np.eye(4, dtype=np.float32)
        rot[:3, :3] = self.rot
        res = rot @ res
        res[:3, 3] -= self.center
        return res

    @property
    def intrinsics(self):
        focal = self.H / (2 * math.tan(math.radians(self.fovy) / 2))
        return np.array([focal, focal, self.W // 2, self.H // 2], np.float32)


def _viewer_inputs(p: ServedPerson, cam: Camera, cond_index: int, scale: float, sc: Scene, smo):
    H = max(int(p.H * scale) // 8 * 8, 8)
    W = max(int(p.W * scale) // 8 * 8, 8)
    fx, fy, cx, cy = (float(v) for v in cam.intrinsics)
    sh, sw = H / cam.H, W / cam.W
    o, d = ref.get_rays(cam.pose, (fx * sw, fy * sh, cx * sw, cy * sh), H, W)
    i = cond_index % len(p.conds)
    cond = ref.cond_window(p.conds, i, smo)
    k = i % len(p.samples)
    yi = (np.arange(H) * p.H // H)[:, None]
    xi = (np.arange(W) * p.W // W)[None, :]
    bg = p.bg[yi, xi].reshape(-1, 3)
    coords = np.stack([(np.arange(H * W) % W) / max(W - 1, 1) * 2 - 1,
                       (np.arange(H * W) // W) / max(H - 1, 1) * 2 - 1], -1).astype(np.float32)
    cap = sc.capacity
    if cap:
        cap = min(-(-int(cap * (H * W) / float(p.H * p.W)) // 4096) * 4096, H * W)
        cap = cap if cap < H * W else None
    return H, W, o, d, cond, bg, coords, ref.pose6(p.poses[k]), cap


def check_live(cfg, rcfg, P, deltas, kept, scale, device, grid_bf16=False) -> dict:
    sc = Scene(cfg, rcfg, P, device, True, grid_bf16)
    p = sc.person
    cam = Camera(p.W, p.H, p.intr, p.poses[0])
    smo = int(cfg["smo_win_size"])
    worst_gap, worst_levels, applied = 0.0, 0, 0
    for n_deltas, cond_index, rgb, u8 in kept:
        while applied < n_deltas:
            cam.orbit(*deltas[applied])
            applied += 1
        H, W, o, d, cond, bg, coords, pose6, cap = _viewer_inputs(p, cam, cond_index, scale, sc, smo)
        out = sc.frame(o, d, cond, bg, cap, coords, pose6)
        g, lv = _gaps(rgb, u8, out["rgb_map"], H, W)
        worst_gap, worst_levels = max(worst_gap, g), max(worst_levels, lv)
    return {"frame_rgb_gap": worst_gap, "frame_u8_exact": float(worst_levels)}


def live_flops(cfg, rcfg, deltas, frames, scale, device) -> tuple:
    """(bfloat16, float32) operations of the window's frames: the head's
    samples by the reference's march of each frame's culled rays, the
    torso's MLPs on every pixel."""
    from counts import flops as fl

    sc = Scene(cfg, rcfg, _no_params(cfg, device), device, True)
    p = sc.person
    cam = Camera(p.W, p.H, p.intr, p.poses[0])
    first = len(deltas) - frames
    bf16 = f32 = 0.0
    for k, dl in enumerate(deltas):
        cam.orbit(*dl)
        if k < first:
            continue
        H, W, o, d, _, _, _, _, cap = _viewer_inputs(p, cam, 0, scale, sc, 1)
        bf16 += sc.count(o, d, cap) * fl.head_sample_flops(cfg)
        f32 += H * W * fl.torso_ray_flops(cfg)
    return bf16, f32
