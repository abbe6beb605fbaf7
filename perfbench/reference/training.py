"""The reference's training steps: the first steps of a run replayed from the
benchmark's weights, the planted occupancy, the raw dataset file and the
seed's jitter, with autograd and a plain multi-group Adam.

What the program drew at random is drawn again here from the same seed, in
the program's order: its generator on the device (seeded ``seed + 1``: the
occupancy sweep's jitter on sweep steps, then each step's march jitter) and
the sweep's frame (``RandomState(seed + 7)``). The ray batches are the ones
the window's feed handed the program: their pixel indices are taken as
given, and their pixels are derived again here from the dataset file and
compared.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pbcore.scene import planted_occupancy
from reference import radnerf as ref

#: the program's sample-capacity and lattice buckets
SPR_BUCKETS = (2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 10.0, 12.0, 16.0)
LATK_BUCKETS = (16, 24, 32, 48, 64, 96, 128)


class Person:
    """The raw dataset file as the reference reads it (train split)."""

    def __init__(self, rcfg: dict):
        ds = np.load(os.path.join(rcfg["data_dir"], "trainval_dataset.npy"), allow_pickle=True).tolist()
        self.samples = list(ds["train_samples"])
        self.H, self.W = int(ds["H"]), int(ds["W"])
        self.intr = (float(ds["focal"]), float(ds["focal"]), float(ds["cx"]), float(ds["cy"]))
        self.bg = np.asarray(ds["bg_img"], np.float32) / 255.0
        self.conds = np.stack([np.asarray(s["idexp_lm3d_normalized_win"], np.float32).reshape(1, 204)
                               for s in self.samples])
        self.poses = np.stack([ref.ngp_pose(s["c2w"], float(rcfg["camera_scale"])) for s in self.samples])

    def pixels(self, idx: int, inds: np.ndarray) -> dict:
        """Ground truth, background and torso-over-background at ``inds``."""
        s = self.samples[idx]
        gt = np.asarray(s["gt_img"], np.float32) / 255.0
        torso = np.asarray(s["torso_img"], np.float32) / 255.0
        bg_t = torso[..., :3] * torso[..., 3:] + self.bg * (1 - torso[..., 3:])
        return {k: v.reshape(-1, 3)[inds] for k, v in (("gt", gt[..., :3]), ("bg", self.bg), ("bg_torso", bg_t))}


def _u8(x):
    return np.clip(x * 255.0 + 0.5, 0, 255).astype(np.int16)


def _groups(P: dict, torso: bool) -> dict:
    if torso:
        return {"net": (1.0, {n: p for n, p in P.items() if n.startswith(("torso_deform", "torso_canonical", "torso_individual"))}),
                "grid": (10.0, {n: p for n, p in P.items() if n.startswith("torso_embeddings")})}
    return {"net": (1.0, {n: p for n, p in P.items() if not n.startswith(("pos_emb", "ambient_emb", "cond_att"))}),
            "grid": (10.0, {n: p for n, p in P.items() if n.startswith(("pos_emb", "ambient_emb"))}),
            "att": (5.0, {n: p for n, p in P.items() if n.startswith("cond_att")})}


def _entropy(a):
    a = a.clamp(1e-5, 1 - 1e-5)
    return torch.mean(-a * torch.log2(a) - (1 - a) * torch.log2(1 - a))


def replay(cfg, rcfg, P0, batches, device, torso, grid_bf16=False, half=False,
           start=None) -> dict:
    """``len(batches)`` steps → losses, the first step's gradients, the
    parameters after the last step, the lattice and capacity buckets in use
    after it, and the largest pixel level gap between the batches and the
    dataset file. Without ``start`` the steps are a run's first, from the
    weights ``P0`` and the planted occupancy. ``start`` begins them at step
    ``k0`` from a state the program held there: its parameters ``theta``, its
    Adam moments ``mu``/``nu`` after ``k0`` updates, its occupancy ``occ``
    (the head's density grid, cells and mean; the torso's alpha grid and
    mean) and the buckets ``latk``/``spr``; the random streams are drawn
    again through the ``k0`` steps before it. ``half`` plants a fault in the
    reference: the loss is the mean over the first half of each batch's
    rays."""
    ref.set_full_fp32()
    person = Person(rcfg)
    theta = P0 if start is None else start["theta"]
    P = {n: p.detach().clone().requires_grad_(True) for n, p in theta.items()}
    head = ref.Head(cfg, P, grid_bf16=grid_bf16)
    tor = ref.Torso(cfg, P, grid_bf16=grid_bf16) if torso else None
    trained = _groups(P, torso)
    adam = ref.Adam(trained, lr=float(cfg["lr"]), b1=float(cfg["optimizer_adam_beta1"]),
                    b2=float(cfg["optimizer_adam_beta2"]))
    seed = int(rcfg["seed"])
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    occ_rng = np.random.RandomState(seed + 7)
    H, bound = int(cfg["grid_size"]), float(cfg["bound"])
    density, occ, mean = (torch.as_tensor(x, device=device)
                          for x in planted_occupancy(H, float(cfg["density_thresh"])))
    t_density = torch.zeros(H * H, device=device)
    t_mean = torch.zeros((), device=device)
    spr, latk = float(cfg["mean_samples_per_ray"]), int(cfg["lattice_K"])
    interval = int(cfg["update_extra_interval"])
    check_every = int(cfg.get("capacity_check_interval", 64))
    n_rays = int(cfg["n_rays"])
    k0 = 0
    if start is not None:
        k0 = int(start["k0"])
        adam.count = k0
        adam.mu = {n: start["mu"][n].clone() for n in adam.mu}
        adam.nu = {n: start["nu"][n].clone() for n in adam.nu}
        if torso:
            t_density, t_mean = (x.clone() for x in start["occ"])
        else:
            density, occ, mean = (x.clone() for x in start["occ"])
        latk, spr = start["latk"], start["spr"]
        for s in range(k0):  # the program's draws before step k0
            if s % interval == 0:
                occ_rng.randint(len(person.samples))
                torch.rand(*((H * H, 2) if torso else (1, H**3, 3)), generator=gen, device=device)
            torch.rand(n_rays, generator=gen, device=device)
    occ0 = occ[0]
    smo = int(cfg["smo_win_size"])
    n_codes = int(cfg["individual_embedding_num"])
    losses, grads1, levels = [], None, 0
    for k, b in enumerate(batches, start=k0):
        if k % interval == 0:
            idx_s = occ_rng.randint(len(person.samples))
            with torch.no_grad():
                if torso:
                    pose_s = torch.as_tensor(ref.pose6(person.poses[idx_s]), device=device)
                    jitter = torch.rand(H * H, 2, generator=gen, device=device)
                    views = tor.views()
                    code = P["torso_individual_codes"][idx_s % n_codes]
                    t_density, t_mean = ref.torso_sweep(
                        lambda xy: tor(xy, pose_s, code, views)[0][:, 0], t_density, jitter, H)
                else:
                    cond = torch.as_tensor(ref.cond_window(person.conds, idx_s, smo), device=device)
                    cf = head.cond(cond)
                    views = head.views()
                    noise = torch.rand(1, H**3, 3, generator=gen, device=device)
                    density, occ, mean = ref.head_sweep(lambda x: head.density(x, cf, views), density,
                                                        noise, H, bound, float(cfg["density_thresh"]))
                    occ0 = occ[0]
        idx = int(b["idx"])
        inds_np = np.asarray(b["inds"]).astype(np.int64)
        px = person.pixels(idx, inds_np)
        for key, mine in (("gt_img_u8", "gt"), ("bg_img_u8", "bg"), ("bg_torso_img_u8", "bg_torso")):
            levels = max(levels, int(np.abs(np.asarray(b[key]).astype(np.int16) - _u8(px[mine])).max()))
        inds = torch.as_tensor(inds_np, device=device)
        pose = torch.as_tensor(person.poses[idx], device=device)
        o, d, i, j = ref.rays_device(pose, person.intr, inds, person.W)
        noises = torch.rand(inds.shape[0], generator=gen, device=device)
        gt = torch.as_tensor(np.asarray(b["gt_img_u8"]), device=device).float() / 255.0
        code_i = min(idx, n_codes - 1)
        cond = torch.as_tensor(ref.cond_window(person.conds, idx, smo), device=device)
        if torso:
            with torch.no_grad():
                cf = head.cond(cond)
                hv = head.views()
                out = ref.render_slab(lambda x, dd: head(x, dd, cf, P["individual_embeddings"][code_i], hv),
                                      o, d, occ0, bound=bound, min_near=float(cfg["min_near"]),
                                      max_steps=int(cfg["max_steps"]), grid_size=H,
                                      dt_gamma=float(cfg["dt_gamma"]), bg=0.0, noises=noises)
            xs = torch.div(inds, person.W, rounding_mode="floor").float() / (person.H - 1) * 2 - 1
            ys = (inds % person.W).float() / (person.W - 1) * 2 - 1
            coords = torch.stack([xs, ys], dim=-1)
            mask = ref.torso_mask(t_density, t_mean, coords, H, float(cfg["density_thresh_torso"]))
            pose_b = torch.as_tensor(ref.pose6(person.poses[idx]), device=device)
            t_out = tor(coords, pose_b, P["torso_individual_codes"][code_i], tor.views())
            bg = torch.as_tensor(np.asarray(b["bg_img_u8"]), device=device).float() / 255.0
            comp = ref.torso_composite(out, t_out, mask, bg)
            bgt = torch.as_tensor(np.asarray(b["bg_torso_img_u8"]), device=device).float() / 255.0
            h = slice(0, inds.shape[0] // 2 if half else None)
            total = torch.mean((comp["torso_rgb_map"][h] - bgt[h]) ** 2) \
                + float(cfg["lambda_weights_entropy"]) * _entropy(comp["torso_alpha_map"][h])
        else:
            cf = head.cond(cond)
            views = head.views()
            bgt = torch.as_tensor(np.asarray(b["bg_torso_img_u8"]), device=device).float() / 255.0
            out = ref.render_rays(lambda x, dd: head(x, dd, cf, P["individual_embeddings"][code_i], views),
                                  o, d, occ0, bound=bound, min_near=float(cfg["min_near"]),
                                  max_steps=int(cfg["max_steps"]), grid_size=H, lattice_K=latk,
                                  mean_samples_per_ray=spr, bg=bgt, noises=noises)
            fr = np.asarray(b["face_rect"], np.float32)
            face = (j >= fr[0]) & (j < fr[1]) & (i >= fr[2]) & (i < fr[3])
            lam = min(float(k) / 250_000.0, 1.0) * float(cfg["lambda_ambient"])
            h = slice(0, inds.shape[0] // 2 if half else None)
            total = torch.mean((out["rgb_map"][h] - gt[h]) ** 2) \
                + float(cfg["lambda_weights_entropy"]) * _entropy(out["weights_sum"][h]) \
                + lam * torch.mean(out["ambient_sum"][h] * (~face[h]))
            if k % check_every == 0:  # the program retunes its buckets on these steps
                need = 1.15 * float(out["march_span"])
                latk = min([x for x in LATK_BUCKETS if x >= need] or [LATK_BUCKETS[-1]])
                want = float(cfg["capacity_headroom"]) * float(out["n_samples"].float().mean())
                spr = min(min([x for x in SPR_BUCKETS if x >= want] or [16.0]), float(cfg["max_steps"]))
        params = [p for _, ps in trained.values() for p in ps.values()]
        names = [n for _, ps in trained.values() for n in ps]
        gs = torch.autograd.grad(total, params, allow_unused=True)
        grads = {n: (torch.zeros_like(p) if g is None else g) for n, p, g in zip(names, params, gs)}
        if k == k0:
            grads1 = {n: g.clone() for n, g in grads.items()}
        adam.step(grads)
        losses.append(float(total.detach()))
    return {"losses": losses, "grads1": grads1, "theta": {n: p.detach() for n, p in P.items()},
            "pixel_levels": levels, "latk": latk, "spr": spr}


def _leaf_gaps(prog: dict, refs: dict, keep=None) -> dict:
    """Each leaf's ``|‖prog‖ − ‖ref‖|`` over the larger of the reference's
    norm of that leaf and of the median leaf."""
    names = [n for n in refs if keep is None or n in keep]
    rn = {n: float(refs[n].double().norm()) for n in names}
    med = float(np.median(list(rn.values())))
    return {n: abs(float(prog[n].double().norm()) - rn[n]) / max(rn[n], med, 1e-30) for n in names}


def _worst(gaps: dict, k: int = 3) -> list:
    return [[n, gaps[n]] for n in sorted(gaps, key=gaps.get, reverse=True)[:k]]


def compare(got: dict, losses: list, grads: dict, theta_after: dict, theta_before: dict,
            prefix: str = "", detail: dict | None = None) -> dict:
    """The numbers compared over one replayed stretch of steps: each step's
    loss, its first step's gradient as the program's optimizer got it, and
    the change of the parameters over the stretch (leaves whose reference
    gradient is under a thousandth of the median leaf's left out). ``detail``
    takes each step's loss gap and the worst leaves of the other two."""
    loss_gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses, got["losses"])]
    grad_gaps = _leaf_gaps({n: grads[n] for n in got["grads1"]}, got["grads1"])
    gn = {n: float(g.double().norm()) for n, g in got["grads1"].items()}
    med = float(np.median(list(gn.values())))
    moved = {n for n, v in gn.items() if v >= 1e-3 * med}
    d_prog = {n: theta_after[n] - theta_before[n] for n in got["grads1"]}
    d_ref = {n: got["theta"][n] - theta_before[n] for n in got["grads1"]}
    change_gaps = _leaf_gaps(d_prog, d_ref, moved)
    if detail is not None:
        detail.update({f"{prefix}loss_steps": loss_gaps, f"{prefix}grad1_worst": _worst(grad_gaps),
                       f"{prefix}change_worst": _worst(change_gaps)})
    return {f"{prefix}loss_rel_gap": max(loss_gaps), f"{prefix}grad1_leaf_gap": max(grad_gaps.values()),
            f"{prefix}change_leaf_gap": max(change_gaps.values())}


def window_flops(cfg, rcfg, steps_seen, occ_at, device, torso) -> tuple:
    """(bfloat16, float32) operations of the window's steps, the samples
    counted by the reference's march of each step's rays and jitter."""
    from counts import flops as fl

    person = Person(rcfg)
    H, bound, n_rays = int(cfg["grid_size"]), float(cfg["bound"]), int(cfg["n_rays"])
    interval = int(cfg["update_extra_interval"])
    seed = int(rcfg["seed"])
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    occ_grid = torch.as_tensor(planted_occupancy(H, float(cfg["density_thresh"]))[1],
                               device=device)[0]
    head_f, dens_f = fl.head_sample_flops(cfg), fl.head_sample_flops(cfg, density_only=True)
    bf16 = f32 = 0.0
    seen = {s: (i, inds) for s, i, inds in steps_seen}
    last = max(seen) if seen else -1
    occ_now = occ_grid
    for s in range(last + 1):
        if s % interval == 0:
            if torso:
                torch.rand(H * H, 2, generator=gen, device=device)
            else:
                torch.rand(1, H**3, 3, generator=gen, device=device)
            if s in seen:
                if torso:
                    f32 += H * H * fl.torso_ray_flops(cfg)
                else:
                    bf16 += H**3 * dens_f
        if s in occ_at:
            occ_now = occ_at[s][0]
        noises = torch.rand(n_rays, generator=gen, device=device)
        if s not in seen:
            continue
        idx, inds = seen[s]
        pose = torch.as_tensor(person.poses[idx], device=device)
        o, d, _, _ = ref.rays_device(pose, person.intr, torch.as_tensor(np.asarray(inds).astype(np.int64), device=device), person.W)
        o, d = o.float().contiguous(), d.float()
        nears, fars = ref.near_far(o, d, ref.make_aabb(bound, device), float(cfg["min_near"]))
        with torch.no_grad():
            if torso:
                m = ref.march_walk(o, d, occ_grid, nears, fars, noises, bound=bound,
                                   max_steps=int(cfg["max_steps"]), grid_size=H,
                                   dt_gamma=float(cfg["dt_gamma"]))
                bf16 += float(m.valid.sum()) * head_f
                f32 += 3 * n_rays * fl.torso_ray_flops(cfg)
            else:
                m = ref.march_lattice(o, d, occ_now, nears, fars, noises, bound=bound,
                                      max_steps=int(cfg["max_steps"]), grid_size=H, lattice_K=LATK_BUCKETS[-1])
                bf16 += 3 * float(m.valid.sum()) * head_f
    return bf16, f32
