"""Landmark visualization + t-SNE embedding plots (port of
``geneface_tpu/utils/visualization.py``).

Render a 68-landmark 3-D sequence to a debug video, and project feature
sets to 2-D with t-SNE for embedding inspection. Rasterization is pure
numpy (no GUI dependency); video muxing reuses the port's
:func:`geneface_tpu_torch.inference.radnerf_infer.save_mp4`. The t-SNE is
exact (O(N²), for debug-scale N): the affinities' per-point perplexity
search on the host (numpy, float64), the gradient descent in float64 torch
on a device (the card unless ``device="cpu"``), from the JAX package's
initial embedding (``np.random.RandomState(seed)``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = [
    "LM68_LINES",
    "draw_landmark_frame",
    "render_lm3d_to_video",
    "tsne",
    "plot_tsne",
]

# 68-landmark skeleton (``draw_3d_landmark.py:30-44``)
LM68_LINES = (
    # jaw
    [(i, i + 1) for i in range(16)]
    # brows
    + [(i, i + 1) for i in range(17, 21)]
    + [(i, i + 1) for i in range(22, 26)]
    # nose
    + [(27, 28), (28, 29), (29, 30), (31, 32), (32, 33), (33, 34), (34, 35)]
    # eyes
    + [(36, 37), (37, 38), (38, 39), (39, 40), (40, 41), (41, 36)]
    + [(42, 43), (43, 44), (44, 45), (45, 46), (46, 47), (47, 42)]
    # mouth
    + [(i, i + 1) for i in range(48, 59)] + [(59, 48)]
    + [(60, 61), (61, 62), (62, 63), (63, 64), (64, 65), (65, 66), (66, 67),
       (67, 60), (48, 60), (54, 64)]
)

_EYE_IDX = set(range(36, 48))
_MOUTH_IDX = set(range(48, 68))


def _disc(img, x, y, r, color):
    H, W, _ = img.shape
    x0, x1 = max(0, x - r), min(W, x + r + 1)
    y0, y1 = max(0, y - r), min(H, y + r + 1)
    if x0 >= x1 or y0 >= y1:
        return
    ys, xs = np.mgrid[y0:y1, x0:x1]
    mask = (xs - x) ** 2 + (ys - y) ** 2 <= r * r
    img[y0:y1, x0:x1][mask] = color


def _line(img, p0, p1, color):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 1
    xs = np.linspace(p0[0], p1[0], n).round().astype(int)
    ys = np.linspace(p0[1], p1[1], n).round().astype(int)
    H, W, _ = img.shape
    ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    img[ys[ok], xs[ok]] = color


def draw_landmark_frame(
    lm2d: np.ndarray,  # [68, 2] pixel coords
    wh: int = 512,
    radius: int = 3,
    draw_lines: bool = True,
) -> np.ndarray:
    """Rasterize one landmark frame → uint8 [wh, wh, 3] (white background;
    eyes red, mouth green, rest blue — ``lm_visualizer.py:27-41``)."""
    img = np.full((wh, wh, 3), 255, np.uint8)
    if draw_lines:
        for a, b in LM68_LINES:
            _line(img, lm2d[a], lm2d[b], (160, 160, 160))
    for i, (x, y) in enumerate(lm2d.astype(int)):
        if i in _EYE_IDX:
            color = (255, 0, 0)
        elif i in _MOUTH_IDX:
            color = (0, 200, 0)
        else:
            color = (0, 0, 255)
        _disc(img, x, y, radius, color)
    return img


def render_lm3d_to_video(
    lm3d: np.ndarray,  # [T, 68, 3] landmarks in [-1, 1] (or idexp/10+mean)
    out_path: str,
    audio_path: str | None = None,
    wh: int = 512,
    fps: int = 25,
) -> str:
    """Render a landmark sequence to an mp4 (``lm_visualizer.py:13-56``).

    ``lm3d`` is mapped ``x -> x*wh/2 + wh/2`` and flipped vertically (the
    reference's ``cv2.flip(img, 0)``).
    """
    from geneface_tpu_torch.inference.radnerf_infer import save_mp4

    lm = np.asarray(lm3d, np.float32).reshape(-1, 68, 3)
    pix = lm[..., :2] * (wh / 2) + wh / 2
    frames = np.stack(
        [draw_landmark_frame(p, wh)[::-1] for p in pix]
    )  # vertical flip
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    return save_mp4(frames.astype(np.float32) / 255.0, out_path, fps=fps,
                    audio_path=audio_path)


# --------------------------------------------------------------------- tsne --
def tsne(
    x: np.ndarray,  # [N, D]
    n_components: int = 2,
    perplexity: float = 30.0,
    n_iter: int = 500,
    lr: float = 200.0,
    seed: int = 0,
    device=None,
) -> np.ndarray:
    """t-SNE (KL descent with momentum + early exaggeration) → float32
    ``[N, n_components]``; the descent runs on ``device`` (default the
    card)."""
    from geneface_tpu_torch import resolve_device

    dev = resolve_device(device)
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    rng = np.random.RandomState(seed)

    # pairwise squared distances -> conditional P with per-point beta search
    d2 = np.sum(x**2, 1)[:, None] + np.sum(x**2, 1)[None] - 2 * x @ x.T
    np.fill_diagonal(d2, 0.0)
    P = np.zeros((n, n))
    target = np.log(perplexity)
    for i in range(n):
        lo, hi, beta = 1e-20, 1e20, 1.0
        di = np.delete(d2[i], i)
        for _ in range(50):
            p = np.exp(-di * beta)
            s = p.sum()
            if s <= 1e-12:
                H = 0.0
            else:
                p = p / s
                H = -np.sum(p * np.log(np.maximum(p, 1e-12)))
            if abs(H - target) < 1e-5:
                break
            if H > target:
                lo = beta
                beta = beta * 2 if hi >= 1e20 else (beta + hi) / 2
            else:
                hi = beta
                beta = beta / 2 if lo <= 1e-20 else (beta + lo) / 2
        row = np.exp(-d2[i] * beta)
        row[i] = 0.0
        P[i] = row / max(row.sum(), 1e-12)
    P = (P + P.T) / (2 * n)
    P = torch.as_tensor(np.maximum(P, 1e-12), device=dev)

    y = torch.as_tensor(rng.normal(0, 1e-4, (n, n_components)), device=dev)
    update = torch.zeros_like(y)
    for it in range(n_iter):
        exagg = 12.0 if it < 100 else 1.0
        momentum = 0.5 if it < 250 else 0.8
        sq = (y**2).sum(1)
        yd2 = sq[:, None] + sq[None] - 2 * y @ y.T
        num = 1.0 / (1.0 + yd2)
        num.fill_diagonal_(0.0)
        Q = (num / num.sum()).clamp(min=1e-12)
        PQ = (exagg * P - Q) * num
        grad = 4.0 * ((torch.diag(PQ.sum(1)) - PQ) @ y)
        update = momentum * update - lr * grad
        y = y + update
        y = y - y.mean(0)
    return y.cpu().numpy().astype(np.float32)


def plot_tsne(
    x: np.ndarray,
    labels: np.ndarray | None = None,
    out_png: str | None = None,
    title: str | None = None,
    **tsne_kwargs,
) -> np.ndarray:
    """t-SNE scatter (matplotlib when available) → returns the 2-D embedding."""
    emb = tsne(x, **tsne_kwargs)
    if out_png:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 8))
        if labels is None:
            ax.scatter(emb[:, 0], emb[:, 1], s=4, alpha=0.6)
        else:
            labels = np.asarray(labels)
            for lab in np.unique(labels):
                m = labels == lab
                ax.scatter(emb[m, 0], emb[m, 1], s=4, alpha=0.6, label=str(lab))
            ax.legend(markerscale=3)
        if title:
            ax.set_title(title)
        os.makedirs(os.path.dirname(os.path.abspath(out_png)), exist_ok=True)
        fig.savefig(out_png, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return emb
