"""Video preprocessing (port of ``geneface_tpu/datagen/process.py``): the
subtasks that turn a person's video into the artifacts
:func:`geneface_tpu_torch.datagen.binarizer.binarize_video` stores.

Wav extraction (1), mel/f0/HuBERT audio features (2), frame extraction
(3), face parsing through a ``parse_fn`` (4), the background (5), the
head/torso/gt images with the seam in-painted (6), landmarks through an
``lm_fn`` or the port's FAN (7), the 3DMM track with its photometric
refinement (8) and the transforms (9).

:func:`process_video` decodes the video with OpenCV (imported inside the
function, as the JAX package does) and hands the frames to
:func:`process_frames`, which runs everything after the decode and imports
neither OpenCV nor Pillow.

Mask convention: 0 background, 1 head, 2 neck, 3 torso.
"""

from __future__ import annotations

import json
import os

import numpy as np

__all__ = [
    "extract_wav16k",
    "extract_frames",
    "reconstruct_background",
    "split_head_torso",
    "export_transforms",
    "process_frames",
    "process_video",
]


def _has_ffmpeg() -> bool:
    import shutil

    return shutil.which("ffmpeg") is not None


def extract_wav16k(video_path: str, out_wav: str | None = None) -> str:
    """Task 1: → 16 kHz mono wav; a .wav source is resampled with scipy, a
    container needs the ffmpeg CLI."""
    out_wav = out_wav or os.path.splitext(video_path)[0] + "_16k.wav"
    if video_path.endswith(".wav"):
        from scipy.io import wavfile

        from geneface_tpu_torch.utils.audio import SR, load_wav16k

        wav = load_wav16k(video_path)
        wavfile.write(out_wav, SR, (wav * 32767).astype(np.int16))
        return out_wav
    if not _has_ffmpeg():
        raise RuntimeError(
            "extracting audio from a video container needs the ffmpeg CLI; "
            "supply a .wav next to the video instead"
        )
    from geneface_tpu_torch.utils.audio import save_wav16k_from_any

    return save_wav16k_from_any(video_path, out_wav)


def extract_frames(video_path: str, out_dir: str, fps: int = 25) -> list[str]:
    """Task 3: decode frames at ``fps`` to ``out_dir/<i>.jpg`` (OpenCV)."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    src_fps = cap.get(cv2.CAP_PROP_FPS) or fps
    step = max(src_fps / fps, 1e-6)
    paths = []
    next_t, i, oi = 0.0, 0, 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i >= next_t - 1e-9:
            p = os.path.join(out_dir, f"{oi:05d}.jpg")
            cv2.imwrite(p, frame, [int(cv2.IMWRITE_JPEG_QUALITY), 98])
            paths.append(p)
            oi += 1
            next_t += step
        i += 1
    cap.release()
    return paths


def reconstruct_background(
    frames: np.ndarray,  # [T, H, W, 3] uint8
    masks: np.ndarray,  # [T, H, W] int (0 = background)
) -> np.ndarray:
    """Task 5: the mean of each pixel's background observations; holes take
    the nearest observed background pixel (scipy's ``cKDTree``)."""
    from scipy.spatial import cKDTree

    T, H, W, _ = frames.shape
    acc = np.zeros((H, W, 3), np.float64)
    cnt = np.zeros((H, W), np.int64)
    for t in range(T):
        bg = masks[t] == 0
        acc[bg] += frames[t][bg]
        cnt[bg] += 1
    seen = cnt > 0
    bg_img = np.zeros((H, W, 3), np.uint8)
    bg_img[seen] = (acc[seen] / cnt[seen, None]).astype(np.uint8)
    if (~seen).any() and seen.any():
        seen_xy = np.argwhere(seen)
        hole_xy = np.argwhere(~seen)
        _, idx = cKDTree(seen_xy).query(hole_xy, k=1)
        bg_img[hole_xy[:, 0], hole_xy[:, 1]] = bg_img[seen_xy[idx, 0], seen_xy[idx, 1]]
    return bg_img


def _inpaint_down(img: np.ndarray, mask: np.ndarray, rows: int = 6) -> np.ndarray:
    """Grow the region down by ``rows`` pixels, each new pixel a copy of the
    one above darkened by 2%."""
    out = img.copy()
    valid = mask.copy()
    for _ in range(rows):
        shifted = np.roll(valid, 1, axis=0)
        shifted[0] = False
        grow = shifted & ~valid
        src = np.roll(out, 1, axis=0)
        out[grow] = (src[grow].astype(np.float32) * 0.98).astype(np.uint8)
        valid |= grow
    return out


def split_head_torso(
    frame: np.ndarray,  # [H, W, 3] uint8
    mask: np.ndarray,  # [H, W] int {0 bg, 1 head, 2 neck, 3 torso}
    bg_img: np.ndarray,  # [H, W, 3] uint8
) -> dict:
    """Task 6: ``gt_img`` (the frame), ``head_img`` (head pixels over the
    background) and ``torso_img`` (RGBA: neck and torso pixels, seam
    in-painted, over transparent)."""
    head = mask == 1
    body = (mask == 2) | (mask == 3)
    head_img = bg_img.copy()
    head_img[head] = frame[head]

    torso_rgb = np.zeros_like(frame)
    torso_rgb[body] = frame[body]
    torso_rgb = _inpaint_down(torso_rgb, body)
    alpha = ((body | (torso_rgb.sum(-1) > 0)) * 255).astype(np.uint8)
    torso_img = np.concatenate([torso_rgb, alpha[..., None]], -1)
    return {"gt_img": frame, "head_img": head_img, "torso_img": torso_img}


def export_transforms(
    out_dir: str,
    track: dict,  # euler [T, 3], trans [T, 3], focal
    H: int,
    W: int,
    face_rects: list,
    val_every: int = 11,
) -> tuple[str, str]:
    """Task 9: ``transforms_{train,val}.json`` — per-frame c2w (the inverse
    of the tracked pose), focal/cx/cy, face rects; one frame in
    ``val_every`` goes to val."""
    from geneface_tpu_torch.utils.camera import euler_trans_to_c2w

    w2c = euler_trans_to_c2w(np.asarray(track["euler"]), np.asarray(track["trans"]))
    c2w = np.linalg.inv(w2c)
    frames = [
        {
            "img_id": i,
            "transform_matrix": c2w[i].tolist(),
            "face_rect": [int(v) for v in face_rects[i]],
        }
        for i in range(len(c2w))
    ]
    base = {"focal_len": float(track["focal"]), "cx": W / 2.0, "cy": H / 2.0, "frames": None}
    train = dict(base, frames=[f for i, f in enumerate(frames) if i % val_every])
    val = dict(base, frames=[f for i, f in enumerate(frames) if not i % val_every])
    os.makedirs(out_dir, exist_ok=True)
    ptr = os.path.join(out_dir, "transforms_train.json")
    pva = os.path.join(out_dir, "transforms_val.json")
    with open(ptr, "w") as f:
        json.dump(train, f)
    with open(pva, "w") as f:
        json.dump(val, f)
    return ptr, pva


def process_frames(
    frames: np.ndarray,  # [T, H, W, 3] uint8 RGB
    out_dir: str,
    parse_fn=None,  # (frame u8 [H, W, 3]) -> mask int [H, W]
    lm_fn=None,  # (frame u8 [H, W, 3]) -> [68, 2] float pixel coordinates
    basis=None,  # face_tracker.FaceBasis
    full_basis=None,  # face_renderer.FullFaceBasis -> photometric refinement
    wav_path: str | None = None,
    fan_npz: str | None = None,  # converted 2DFAN4 weights -> the port's FAN
    device=None,
) -> dict:
    """Tasks 2 and 4–9 on decoded frames → the manifest
    :func:`~geneface_tpu_torch.datagen.binarizer.binarize_video` reads.
    The networks, the tracker and the refinement run on ``device`` (the
    card by default)."""
    from geneface_tpu_torch.datagen.face_tracker import fit_sequence, refine_photometric
    from geneface_tpu_torch.utils.audio import (
        extract_f0,
        extract_hubert,
        load_wav16k,
        melspectrogram,
    )

    os.makedirs(out_dir, exist_ok=True)
    audio = {"mel": None, "f0": None, "hubert": None}
    if wav_path is not None:
        wav = load_wav16k(wav_path)
        audio = {
            "mel": melspectrogram(wav),
            "f0": extract_f0(wav),
            "hubert": extract_hubert(wav, device=device),  # None without a checkpoint
        }
    frames = np.asarray(frames)
    T, H, W, _ = frames.shape

    if parse_fn is None:
        raise ValueError(
            "face parsing needs a parse_fn (BiSeNet weights are not shipped); "
            "see geneface_tpu_torch.datagen.face_parser"
        )
    masks = np.stack([parse_fn(f) for f in frames])
    bg_img = reconstruct_background(frames, masks)
    splits = [split_head_torso(frames[t], masks[t], bg_img) for t in range(T)]

    if lm_fn is None and fan_npz:
        from geneface_tpu_torch.datagen.face_landmarker import FANLandmarker

        fan = FANLandmarker.from_npz(fan_npz, device=device)
        lms = np.stack([fan(frames[t], masks[t]) for t in range(T)])
    elif lm_fn is None:
        raise ValueError(
            "landmark extraction needs an lm_fn (68-point) or fan_npz "
            "(converted 2DFAN4 weights, tools/convert_fan_torch.py)"
        )
    else:
        lms = np.stack([lm_fn(f) for f in frames])  # [T, 68, 2]
    rects = []
    for t in range(T):
        xs, ys = lms[t, :, 1], lms[t, :, 0]
        rects.append((int(xs.min()), int(xs.max()) + 1, int(ys.min()), int(ys.max()) + 1))

    if basis is None:
        raise ValueError("face tracking needs a FaceBasis (see basis_from_bfm)")
    track = fit_sequence(lms, basis, H, W, device=device)
    if full_basis is not None:
        track = refine_photometric(track, full_basis, frames.astype(np.float32) / 255.0, lms,
                                   H, W, device=device)
    export_transforms(out_dir, track, H, W, rects)

    return {
        "out_dir": out_dir,
        "wav_path": wav_path,
        "audio": audio,
        "frames": frames,
        "masks": masks,
        "bg_img": bg_img,
        "splits": splits,
        "lms": lms,
        "track": track,
        "face_rects": rects,
        "H": H,
        "W": W,
    }


def process_video(
    video_path: str,
    out_dir: str,
    parse_fn=None,
    lm_fn=None,
    basis=None,
    full_basis=None,
    fps: int = 25,
    max_frames: int | None = None,
    wav_path: str | None = None,  # pre-extracted audio; skips task 1
    fan_npz: str | None = None,
    device=None,
) -> dict:
    """Tasks 1–9 on a video file: the wav (task 1, unless ``wav_path``), the
    frames decoded with OpenCV (task 3), then :func:`process_frames`."""
    os.makedirs(out_dir, exist_ok=True)
    if wav_path is None and (video_path.endswith(".wav") or _has_ffmpeg()):
        wav_path = extract_wav16k(video_path, os.path.join(out_dir, "aud_16k.wav"))
    frame_paths = extract_frames(video_path, os.path.join(out_dir, "frames"), fps)
    if max_frames:
        frame_paths = frame_paths[:max_frames]
    import cv2

    frames = np.stack([cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB) for p in frame_paths])
    return process_frames(frames, out_dir, parse_fn=parse_fn, lm_fn=lm_fn, basis=basis,
                          full_basis=full_basis, wav_path=wav_path, fan_npz=fan_npz,
                          device=device)
