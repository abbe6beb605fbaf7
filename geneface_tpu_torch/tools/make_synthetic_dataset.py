"""Generate a synthetic ``trainval_dataset.npy`` in the binarizer's format
(the port's own copy of the JAX package's ``tools/make_synthetic_dataset.py``,
so that the port and ``chip_smoke.py`` import nothing outside
``geneface_tpu_torch``; same arrays for the same arguments).

The scene is an analytically-rendered lambertian sphere ("head") bobbing with
the conditioning signal, so training has real structure to fit: cameras orbit
slightly, images contain the sphere over a gradient background, landmarks are
synthesized as points on the sphere. Used by ``chip_smoke.py`` and the
tests when no real preprocessed video is available.

Usage: python -m geneface_tpu_torch.tools.make_synthetic_dataset
         --out data/binary/videos/Synth [--frames 40] [--hw 128]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def render_sphere_frame(H, W, focal, c2w, center, radius, light_dir, bg):
    """Analytic ray-traced sphere in OpenGL camera convention (host numpy)."""
    i = np.arange(W, dtype=np.float32)[None, :].repeat(H, 0) + 0.5
    j = np.arange(H, dtype=np.float32)[:, None].repeat(W, 1) + 0.5
    dirs = np.stack(
        [(i - W / 2) / focal, -(j - H / 2) / focal, -np.ones_like(i)], -1
    )
    rd = dirs @ c2w[:3, :3].T
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = c2w[:3, 3]
    oc = ro - center
    b = np.sum(rd * oc, -1)
    c = np.sum(oc * oc) - radius**2
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0))
    hit &= t > 0
    pt = ro + rd * t[..., None]
    n = (pt - center) / radius
    lam = np.clip(np.sum(n * light_dir, -1), 0, 1)
    col = np.stack([0.8 * lam + 0.15, 0.55 * lam + 0.1, 0.45 * lam + 0.1], -1)
    img = np.where(hit[..., None], col, bg)
    return np.clip(img, 0, 1), hit


def make_dataset(out_dir, n_frames=40, hw=128, seed=0):
    rng = np.random.RandomState(seed)
    H = W = hw
    focal = hw * 1.2
    bg = np.linspace(0.2, 0.6, H)[:, None, None] * np.ones((H, W, 3), np.float32)
    light = np.array([0.3, 0.5, 0.8])
    light = light / np.linalg.norm(light)

    samples = []
    lm_all = []
    for fi in range(n_frames):
        phase = fi / max(n_frames - 1, 1) * 2 * np.pi
        # mild camera orbit; camera at z ~ +0.6 in nerf convention, radius
        # chosen so that after ngp conversion (scale=4) the head fills
        # [-1,1]^3 roughly
        ang = 0.15 * np.sin(phase)
        cpos = np.array([0.6 * np.sin(ang), 0.02 * np.sin(2 * phase), 0.6 * np.cos(ang)])
        fwd = -cpos / np.linalg.norm(cpos)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        up2 = np.cross(right, fwd)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up2, -fwd, cpos

        # the "mouth" bobs with the condition signal
        mouth_open = 0.5 + 0.5 * np.sin(3 * phase)
        center = np.array([0.0, -0.01 * mouth_open, 0.0])
        radius = 0.11 + 0.005 * mouth_open
        img, hit = render_sphere_frame(H, W, focal, c2w, center, radius, light, bg)

        rows = np.where(hit.any(1))[0]
        cols = np.where(hit.any(0))[0]
        if len(rows):
            face_rect = (int(rows.min()), int(rows.max() + 1), int(cols.min()), int(cols.max() + 1))
        else:
            face_rect = (H // 4, 3 * H // 4, W // 4, 3 * W // 4)

        # landmarks: 68 points on the sphere surface, jittering with mouth
        theta = np.linspace(0, 2 * np.pi, 68, endpoint=False)
        lm3d = np.stack(
            [
                radius * np.cos(theta),
                radius * np.sin(theta) * (1 + 0.2 * mouth_open),
                np.full(68, radius * 0.5),
            ],
            -1,
        ) + center
        lm_all.append(lm3d)

        samples.append(
            {
                "idx": fi,
                "c2w": c2w,
                "gt_img": (img * 255).astype(np.uint8),
                "torso_img": np.concatenate(
                    [
                        (bg * 255).astype(np.uint8),
                        np.zeros((H, W, 1), np.uint8),
                    ],
                    -1,
                ),
                "face_rect": face_rect,
                "idexp_lm3d_raw": lm3d.astype(np.float32),
            }
        )

    lm_all = np.stack(lm_all)  # [T, 68, 3]
    mean = lm_all.mean(0)
    std = lm_all.std(0) + 1e-8
    ds_rng = np.random.RandomState(seed + 1)
    for s in samples:
        norm = (s.pop("idexp_lm3d_raw") - mean) / std
        s["idexp_lm3d_normalized_win"] = norm.reshape(1, 204).astype(np.float32)
        # synthetic ASR features so the deepspeech/esperanto-conditioned
        # families (ADNeRF) train/infer on this dataset too
        s["deepspeech_win"] = ds_rng.randn(16, 29).astype(np.float32)
        s["esperanto_win"] = ds_rng.randn(16, 44).astype(np.float32)

    n_val = max(1, n_frames // 10)
    ds = {
        "H": H,
        "W": W,
        "focal": focal,
        "cx": W / 2,
        "cy": H / 2,
        "bg_img": (bg * 255).astype(np.uint8),
        "idexp_lm3d_mean": mean.astype(np.float32),
        "idexp_lm3d_std": std.astype(np.float32),
        "train_samples": samples[:-n_val],
        "val_samples": samples[-n_val:],
    }
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trainval_dataset.npy")
    np.save(path, ds, allow_pickle=True)
    return path


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="data/binary/videos/Synth")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--hw", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    p = make_dataset(args.out, args.frames, args.hw, args.seed)
    print(f"wrote {p}")
