"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path once at the full width of
``egs/egs_bases/radnerf/lm3d_radnerf.yaml``: random weights from a seeded
``torch.Generator``, the occupancy ball of ``bench.py`` (radius 0.6), a
512² synthetic 8-frame dataset, and ``RADNeRFInfer.render_frames`` on
``cuda``. It builds every CUDA kernel of the path from ``csrc/`` (one
``nvcc`` per source, started together), checks that the main path launched
each of them, holds every kernel against its plain PyTorch version on the
inputs captured from a real frame, times kernel / plain / library call,
and checks the frame against the port's plain CPU path.

Prints, before the last line: the card's name and power limit, ms/frame,
the ray and sample capacities, the device time of one frame by renderer
stage (``torch.profiler``; the full table goes to
``smoke_out/frame_profile.txt``), and one ``{"kernels": [...]}`` JSON line.
Kernel times (``ms``, ``plain_ms``, ``library_ms``) are device times from
the profiler; ``ms_events`` adds the host's launch gaps.
The last line is ``{"ok": true, "device": {...}}``. Any failure exits
non-zero; without a card it exits 1 and prints no result.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HW = 512
N_FRAMES = 8
RENDER_FRAMES = 4
#: H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and float32
#: (non-tensor-core) operations/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12


def production_cfg(data_dir: str, work_dir: str) -> dict:
    """The full-width head config (``lm3d_radnerf.yaml`` through
    ``base.yaml``), as ``bench.py`` lists its keys."""
    return dict(
        data_dir=data_dir, work_dir=work_dir,
        cond_type="idexp_lm3d_normalized", cond_win_size=1, smo_win_size=5,
        cond_out_dim=64, with_att=True, bound=1, grid_type="tiledgrid",
        log2_hashmap_size=16, desired_resolution=2048, grid_size=128,
        grid_num_levels=8, grid_level_dim=4, grid_backend="fused",
        fused_row_lanes=256, num_layers_ambient=3, hidden_dim_ambient=128,
        num_layers_sigma=3, hidden_dim_sigma=128, geo_feat_dim=128,
        num_layers_color=2, hidden_dim_color=128,
        individual_embedding_num=13000, individual_embedding_dim=4,
        max_steps=16, mean_samples_per_ray=8, density_thresh=10,
        dt_gamma=1.0 / 256, near=0.3, far=0.9, min_near=0.05, seed=0,
    )


def planted_occupancy(grid_size: int, density_thresh: float, radius: float = 0.6):
    """``bench.py``'s trained-grid emulation: a dense ball of occupied cells."""
    import numpy as np

    H = grid_size
    r = (np.arange(H) + 0.5) / H * 2.0 - 1.0
    gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
    occ = np.sqrt(gx**2 + gy**2 + gz**2) < (radius + 4.0 / H)
    density = np.where(occ, 4.0 * density_thresh, 0.0).reshape(1, -1).astype(np.float32)
    return density, occ[None], np.float32(0.0)


def write_scene(root: str, hw: int, n_frames: int, seed: int = 0) -> dict:
    """Synthetic dataset + a seeded random checkpoint in the JAX layout."""
    import torch

    sys.path.insert(0, REPO)
    from tools.make_synthetic_dataset import make_dataset

    from geneface_tpu_torch.convert import state_dict_to_flax
    from geneface_tpu_torch.models.radnerf import model_from_cfg
    from geneface_tpu_torch.utils.checkpoint import save_checkpoint

    data, work = os.path.join(root, "data"), os.path.join(root, "work")
    make_dataset(data, n_frames=n_frames, hw=hw, seed=seed)
    cfg = production_cfg(data, work)
    model = model_from_cfg(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    occ = planted_occupancy(cfg["grid_size"], cfg["density_thresh"])
    save_checkpoint(
        os.path.join(work, "model_ckpt_steps_0.ckpt"),
        {"state": {"params": state_dict_to_flax(model.state_dict()), "occ": occ}, "step": 0},
    )
    return cfg


def build_kernels() -> str:
    """One nvcc per ``csrc/*.cu``, all started together."""
    from geneface_tpu_torch import kernels

    names = sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob.glob(os.path.join(kernels.CSRC_DIR, "*.cu"))
    )
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    procs = {
        n: subprocess.Popen(
            kernels.build_command(n), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for n in names
    }
    log = []
    for n, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}:\n{out}")
        os.replace(kernels.library_path(n) + ".part", kernels.library_path(n))
        log.append(f"== {n}\n{out}")
    for n in names:
        kernels.load_kernel(n)
    return "\n".join(log)


def events_ms(fn, iters: int = 20) -> float:
    """Mean time of ``fn()`` between CUDA events over ``iters`` back-to-back
    runs after a warm-up: device time plus any gap the host's launches
    leave between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_events(prof):
    """Kernels, copies and fills on the device (not the ``gf::`` stage
    ranges, which the profiler also places on the device timeline)."""
    from torch.autograd import DeviceType

    return [
        e for e in prof.key_averages()
        if e.device_type != DeviceType.CPU and not e.key.startswith("gf::")
    ]


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn()`` (the sum of the kernels, copies and
    fills it runs, from ``torch.profiler``) over ``iters`` runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in _device_events(prof))
    if total_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return total_us / 1e3 / iters


def measure_scatter_site(rows, updates, n_rows, exact: bool) -> dict:
    """Kernel vs plain vs library call on one captured call site."""
    import torch

    from geneface_tpu_torch.ops import scatter as sc

    got = sc.scatter_add_rows(rows, updates, n_rows)
    ref = sc.scatter_add_rows_plain(rows, updates, n_rows)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    if exact:
        if err != 0.0:
            raise AssertionError(f"frame scatter (unique rows) not exact: {err}")
    else:
        # float32 sums of the same terms in atomic order: stated tolerance
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    kept = (rows >= 0) & (rows < n_rows)
    n_kept = int(kept.sum())
    M, W = updates.shape
    # the library yardstick: one index_add_ on in-range rows (redirected to
    # a spill row outside the timed call)
    safe = torch.where(kept, rows, n_rows).long()
    upd32 = updates.float()

    def library():
        return torch.zeros(n_rows + 1, W, device=updates.device).index_add_(0, safe, upd32)

    n_bytes = M * 4 + n_kept * W * updates.element_size() + n_rows * W * 4
    n_ops = n_kept * W
    return {
        "M": M, "W": W, "n_rows": int(n_rows), "kept_rows": n_kept,
        "max_abs_err": err,
        "ms": device_ms(lambda: sc.scatter_add_rows(rows, updates, n_rows)),
        "plain_ms": device_ms(lambda: sc.scatter_add_rows_plain(rows, updates, n_rows)),
        "library_ms": device_ms(library),
        "ms_events": events_ms(lambda: sc.scatter_add_rows(rows, updates, n_rows)),
        "bytes_ms": n_bytes / PEAK_BYTES_S * 1e3,
        "ops_ms": n_ops / PEAK_F32_OPS_S * 1e3,
    }


def capture_scatter_calls(infer, frame: int) -> list:
    """(rows, updates, n_rows) of every K1 call of one frame's render."""
    from geneface_tpu_torch.models.radnerf import renderer

    calls = []
    real = renderer.scatter_add_rows

    def recorder(rows, updates, n_rows):
        calls.append((rows.clone(), updates.clone(), int(n_rows)))
        return real(rows, updates, n_rows)

    renderer.scatter_add_rows = recorder
    try:
        infer.render_frame(frame)
    finally:
        renderer.scatter_add_rows = real
    return calls


def profile_frame(infer, out_dir: str, steady_ms: float) -> dict:
    """Device time of one steady frame by kernel, and the device-timeline
    span of each renderer stage (``gf::*`` ranges: its kernels plus the gaps
    between them), from ``torch.profiler``; the table goes to
    ``out_dir/frame_profile.txt``. The idle share compares the kernels' sum
    with the unprofiled frame's wall time ``steady_ms``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    infer.render_frame(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        infer.render_frame(0)
        torch.cuda.synchronize()
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in _device_events(prof)),
        key=lambda k: -k[1],
    )
    stages = {
        e.key: e.device_time_total / 1e3
        for e in prof.key_averages() if e.key.startswith("gf::")
    }
    busy = sum(k[1] for k in kernels)
    with open(os.path.join(out_dir, "frame_profile.txt"), "w") as f:
        f.write(f"steady wall {steady_ms:.3f} ms, device busy {busy:.3f} ms\n")
        for name, ms in sorted(stages.items(), key=lambda s: -s[1]):
            f.write(f"stage {name:24s} {ms:9.3f} ms\n")
        for name, ms, n in kernels:
            f.write(f"{ms:9.3f} ms {n:5d}x {name}\n")
    return {"steady_ms": steady_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / steady_ms), "stages_ms": stages,
            "top_kernels": [[k[0][:100], k[1], k[2]] for k in kernels[:12]]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import numpy as np

    from geneface_tpu_torch.inference import RADNeRFInfer
    from geneface_tpu_torch.ops import scatter as sc

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.time()
    build_log = build_kernels()
    print(f"kernels built in {time.time() - t0:.1f} s")
    out_dir = os.path.join(REPO, "smoke_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_build.log"), "w") as f:
        f.write(build_log)

    root = os.path.join(REPO, ".smoke_work")
    shutil.rmtree(root, ignore_errors=True)
    try:
        cfg = write_scene(root, HW, N_FRAMES)
        infer = RADNeRFInfer(cfg)  # cuda, bf16 MLPs

        # warm-up (first launches, allocator), then the counted main path
        infer.render_frames(1)
        torch.cuda.synchronize()
        for k in sc.LAUNCHES:
            sc.LAUNCHES[k] = 0
        t1 = time.perf_counter()
        frames = infer.render_frames(RENDER_FRAMES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = dict(sc.LAUNCHES)

        if frames.shape != (RENDER_FRAMES, HW, HW, 3) or frames.dtype != np.uint8:
            raise AssertionError(f"frames {frames.shape} {frames.dtype}")
        if launches["scatter_add_rows"] != 2 * RENDER_FRAMES:
            raise AssertionError(f"scatter_add_rows launched {launches} times")
        last = infer.last_render
        if not torch.isfinite(last["rgb_map"]).all():
            raise AssertionError("non-finite pixels")
        bg = torch.as_tensor(infer.dataset[RENDER_FRAMES - 1]["bg_torso_img"], device="cuda")
        if float((last["rgb_map"] - bg).abs().max()) < 0.02:
            raise AssertionError("the head does not show against the background")

        # steady-state per-frame time (per-video constants already built)
        def one_frame():
            return infer.render_frame(0)["rgb_map"]

        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            one_frame()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - ts) * 1e3)
        C = infer.ray_capacity
        Mc = -(-C * int(cfg["mean_samples_per_ray"]) // 1024) * 1024
        n_samples = last["n_samples"].float()
        print(f"ms/frame: {wall / RENDER_FRAMES * 1e3:.3f} (render_frames of "
              f"{RENDER_FRAMES}, per-video set-up included); steady render_frame "
              f"median {sorted(times)[2]:.3f} ms [{smi}]")
        print(f"ray capacity C={C}, sample capacity Mc={Mc}, mean samples/ray "
              f"{float(n_samples.mean()):.3f} over the C rendered rays "
              f"(hit rays: {int((n_samples > 0).sum())})")

        # frame vs the port's plain CPU path (same checkpoint, same dtype)
        cpu = RADNeRFInfer(cfg, device="cpu")
        cpu.prepare()
        if cpu.ray_capacity != C:
            raise AssertionError(f"capacity {cpu.ray_capacity} on CPU vs {C}")
        ref = cpu.render_frame(0)["rgb_map"]
        gpu = infer.render_frame(0)["rgb_map"].cpu()
        diff = (gpu - ref).abs()
        print(f"frame 0 vs CPU plain path: max abs {float(diff.max()):.3e}, "
              f"mean abs {float(diff.mean()):.3e}")
        # bf16 MLPs on both sides: a hidden unit may round the other way
        if float(diff.max()) > 1e-3 or float(diff.mean()) > 1e-6:
            raise AssertionError("GPU frame disagrees with the CPU plain path")

        # K1 against its plain version at both call sites of a real frame
        calls = capture_scatter_calls(infer, 0)
        if len(calls) != 2:
            raise AssertionError(f"expected 2 scatter calls per frame, got {len(calls)}")
        sites = []
        for (rows, upd, n_rows), name, exact in zip(
            calls, ("composite_sums", "frame_scatter"), (False, True)
        ):
            s = measure_scatter_site(rows, upd, n_rows, exact)
            s["site"] = name
            sites.append(s)
        bytes_ms = sum(s["bytes_ms"] for s in sites)
        ops_ms = sum(s["ops_ms"] for s in sites)
        k1 = {
            "name": "scatter_add_rows",
            "route": "cuda",
            "source": "geneface_tpu_torch/csrc/scatter_add_rows.cu",
            "replaces": "geneface_tpu/ops/pallas_scatter.py:79",
            "launches": launches["scatter_add_rows"],
            "max_abs_err": max(s["max_abs_err"] for s in sites),
            "ms": sum(s["ms"] for s in sites),
            "plain_ms": sum(s["plain_ms"] for s in sites),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": sum(s["library_ms"] for s in sites),
            "per_frame_of": "both call sites of one frame",
            "sites": sites,
        }
        kernels_line = {"kernels": [k1]}
        record = {"gpu": smi, "ms_per_frame": wall / RENDER_FRAMES * 1e3,
                  "steady_ms": times, "ray_capacity": C, "sample_capacity": Mc,
                  **kernels_line}
        record["profile"] = prof = profile_frame(infer, out_dir, sorted(times)[2])
        print(f"frame device time {prof['device_busy_ms']:.3f} ms of "
              f"{prof['steady_ms']:.3f} ms wall (idle share {prof['idle_share']:.3f}); "
              "stages ms " + json.dumps({k: round(v, 3) for k, v in prof["stages_ms"].items()}))
        with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
            json.dump(record, f, indent=1)
        print(json.dumps(kernels_line))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
