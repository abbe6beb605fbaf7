"""Validate the import of a GeneFace (PyTorch) RAD-NeRF checkpoint end to
end in the port (the port of ``tools/validate_import.py``, same flags, same
JSON report)::

    python -m geneface_tpu_torch.tools.validate_import \
        --ckpt <GeneFace work dir or model_ckpt_steps_*.ckpt> \
        --data_dir data/binary/videos/May \
        [--config egs/datasets/videos/May/lm3d_radnerf_import.yaml] \
        [--golden <dir of frame_%05d.npy/.png>] [--frames 4] \
        [--out import_report.json] [--psnr_pass 30] [--dump_frames <dir>] \
        [--device cuda]

It reads the checkpoint (:mod:`geneface_tpu_torch.utils.torch_import`),
builds the config's model under the ``block`` grid backend (the canonical
per-level table: the import's fast path), converts the parameters and the
density grid (and the torso's 2-D grid), renders ``--frames`` evenly spaced
frames of ``trainval_dataset.npy`` with their ground-truth conditions
through the walk and the padded slab without the cull, and reports each
frame's PSNR:

- against ``--golden`` (frames rendered by GeneFace, ``frame_%05d.npy``
  ``[H, W, 3]`` in [0, 1], or ``.png``) when given: PASS iff every frame
  reaches ``--psnr_pass`` dB;
- against the dataset's ground truth always (for information).

The exit code is 0 on PASS. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

__all__ = ["psnr", "load_golden", "validate", "main"]


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else float(-10.0 * np.log10(mse))


def load_golden(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        g = np.load(path)
    else:
        import cv2

        g = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB) / 255.0
    return np.asarray(g, np.float32)


def validate(ckpt: str, data_dir: str, config: str | None = None, frames: int = 4,
             golden: str | None = None, psnr_pass: float = 30.0, out: str | None = None,
             dump_frames: str | None = None, device=None) -> dict:
    """The report ``{"ckpt", "data_dir", "torso", "grid_backend", "frames":
    [{"index", "finite", "psnr_vs_gt", ...}], "pass", ...}``, also written
    to ``out``."""
    import torch

    from geneface_tpu_torch import resolve_device
    from geneface_tpu_torch.config import Config, load_config
    from geneface_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
    from geneface_tpu_torch.data.radnerf_dataset import RADNeRFDataset
    from geneface_tpu_torch.models.radnerf import (
        TorsoOccupancyState,
        model_from_cfg,
        occupancy_view,
        render_rays_radnerf,
        render_rays_radnerf_torso,
    )
    from geneface_tpu_torch.utils import torch_import as ti

    dev = resolve_device(device)
    # config: --config > <ckpt dir>/config.yaml > the defaults
    ckpt_dir = ckpt if os.path.isdir(ckpt) else os.path.dirname(ckpt)
    if config:
        cfg = load_config(config)
    elif os.path.exists(os.path.join(ckpt_dir, "config.yaml")):
        cfg = load_config(os.path.join(ckpt_dir, "config.yaml"))
    else:
        cfg = Config()
    cfg["data_dir"] = data_dir
    cfg["grid_backend"] = "block"  # the canonical per-level table, the fast path

    sd = ti.load_reference_checkpoint(ckpt)
    is_torso = "torso_embedder.embeddings" in sd
    model = model_from_cfg(cfg, torso=is_torso)
    params = ti.radnerf_params_from_torch(sd, state_dict_to_flax(model.state_dict()))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in flax_to_state_dict(params).items()})
    model.to(dev).eval()
    grid_size = int(cfg.get("grid_size", 128))
    bound = float(cfg.get("bound", 1))
    occ = ti.occupancy_from_torch(sd, grid_size, float(cfg.get("density_thresh", 10)))
    view = occupancy_view(torch.as_tensor(occ.occ_grid, device=dev), bound)
    torso_occ = None
    if is_torso and "density_grid_torso" in sd:
        tg = ti.torso_density_grid_from_torch(sd, grid_size).reshape(-1)
        torso_occ = TorsoOccupancyState(torch.as_tensor(tg, device=dev),
                                        torch.as_tensor(tg.mean(), device=dev))
    kwargs = dict(
        bound=bound, min_near=float(cfg.get("min_near", 0.05)),
        dt_gamma=float(cfg.get("dt_gamma", 1.0 / 256)), max_steps=int(cfg.get("max_steps", 16)),
        grid_size=grid_size,
        # the exact full-slab walk: fidelity over speed
        mean_samples_per_ray=None, lattice_K=None,
    )

    ds = RADNeRFDataset("trainval", data_dir, cfg, training=False)
    idxs = np.linspace(0, len(ds) - 1, frames).astype(int).tolist()
    report = {"ckpt": ckpt, "data_dir": data_dir, "torso": bool(is_torso),
              "grid_backend": "block", "frames": []}
    ok = True
    for i in idxs:
        item = ds[i]

        def t(x):
            return torch.as_tensor(np.asarray(x), device=dev)

        with torch.inference_mode():
            cond_feat = model.cal_cond_feat(t(item["cond_wins"]))
            codes = model.individual_embeddings
            ind = codes[0] if codes is not None else None

            def field_fn(x, d):
                return model(x, d, cond_feat, ind)

            if torso_occ is not None:
                t_codes = model.torso_individual_codes
                t_ind = t_codes[0] if t_codes is not None else None
                pose6 = t(item["pose"])
                res = render_rays_radnerf_torso(
                    field_fn,
                    lambda xy, hi, hw: model.forward_torso(xy, pose6, t_ind, hi, hw),
                    t(item["rays_o"]), t(item["rays_d"]), t(item["bg_coords"]), view,
                    torso_occ, density_thresh_torso=float(cfg.get("density_thresh_torso", 0.01)),
                    bg_color=t(item["bg_img"]), **kwargs,
                )
            else:
                res = render_rays_radnerf(field_fn, t(item["rays_o"]), t(item["rays_d"]), view,
                                          bg_color=t(item["bg_torso_img"]), **kwargs)
        rgb = res["rgb_map"].float().cpu().numpy().reshape(ds.H, ds.W, 3)
        entry = {"index": int(i), "finite": bool(np.all(np.isfinite(rgb)))}
        if dump_frames:
            os.makedirs(dump_frames, exist_ok=True)
            np.save(os.path.join(dump_frames, f"frame_{i:05d}.npy"), rgb)
        entry["psnr_vs_gt"] = round(psnr(rgb, ds._gt(ds.samples[i])), 2)
        if golden:
            gpath = os.path.join(golden, f"frame_{i:05d}")
            for ext in (".npy", ".png"):
                if os.path.exists(gpath + ext):
                    entry["psnr_vs_golden"] = round(psnr(rgb, load_golden(gpath + ext)), 2)
                    entry["golden_pass"] = entry["psnr_vs_golden"] >= psnr_pass
                    ok = ok and entry["golden_pass"]
                    break
            else:
                entry["golden_pass"] = False
                entry["golden_missing"] = True
                ok = False
        ok = ok and entry["finite"]
        report["frames"].append(entry)
        print(f"frame {i}: {entry}", flush=True)

    report["pass"] = bool(ok)
    if golden:
        vals = [f["psnr_vs_golden"] for f in report["frames"] if "psnr_vs_golden" in f]
        if vals:
            report["min_psnr_vs_golden"] = min(vals)
    print(f"RESULT: {'PASS' if ok else 'FAIL'}")
    if out:
        with open(out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"report written to {out}")
    return report


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True, help="GeneFace work dir or model_ckpt_steps_*.ckpt")
    ap.add_argument("--data_dir", required=True,
                    help="binarized video dir holding trainval_dataset.npy")
    ap.add_argument("--config", default=None)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--golden", default=None,
                    help="dir of GeneFace-rendered frame_%%05d.npy/.png")
    ap.add_argument("--psnr_pass", type=float, default=30.0)
    ap.add_argument("--out", default="import_report.json")
    ap.add_argument("--dump_frames", default=None,
                    help="also save rendered frames as frame_%%05d.npy here")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    report = validate(a.ckpt, a.data_dir, a.config, a.frames, a.golden, a.psnr_pass, a.out,
                      a.dump_frames, a.device)
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
