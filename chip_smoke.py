"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's fifteen paths at the full width of
``egs/egs_bases/radnerf/lm3d_radnerf.yaml`` (and ``lm3d_radnerf_torso.yaml``)
on a 512² synthetic 8-frame dataset, of HuBERT-large, ``VAEModel(204)``
and ``CNNPostNet(204)`` (``egs/datasets/videos/May/lm3d_postnet_sync.yaml``),
and of the vanilla NeRF (``egs/egs_bases/nerf/lm3d_nerf.yaml``,
``lm3d_nerf_torso.yaml``), with random weights from a seeded
``torch.Generator``:

- head serving: the occupancy ball of ``bench.py`` (radius 0.6) and
  ``RADNeRFInfer.render_frames`` on ``cuda``, the frame checked against the
  port's plain CPU path;
- head training: ``RADNeRFTask.train_step`` for 20 steps of 65,536 rays
  (the occupancy sweeps of steps 0 and 16 included), every loss finite, a
  non-zero gradient in every parameter group, and one step's loss and
  gradients checked against the port's plain CPU path on 4,096 rays; the
  dataset's batch assembly timed apart from the step, numpy against the
  native loader (``native_loader``; the steps keep the numpy path);
- data parallelism (``ddp``): (a) ``Trainer.fit`` of the training cell
  for 20 steps through ``initialize_distributed`` as an NCCL group of
  world size 1 against two runs without a process group (each step's
  loss, the final parameters, the plain runs' own spread); (b) two gloo
  ranks sharing ``cuda:0`` (``torch.multiprocessing.spawn``), 6 head
  steps with a sweep and 2 lip steps of 64² patches at float32 MLPs, each
  step started from the one-rank run's parameters and its loss and
  gradients held against that run's step on the card,
  the occupancy bit-equal across ranks, the gradient all-reduce's bytes
  and ms, ms/step and rank 0's idle share; (c) ``render_video`` of 4
  torso frames split over the two ranks against the one-process render,
  the mp4 written once; K1 and K8 at the ranks' sites (``ddp.*``);
- torso serving: a torso checkpoint (the same head, seeded torso weights, a
  torso occupancy planted over the lower half of the screen) through
  ``RADNeRFInfer.render_frames``, checked against the CPU plain path, the
  torso showing against the background inside its mask;
- torso training: ``RADNeRFTorsoTask.train_step`` for 20 steps of 65,536
  rays on the head checkpoint (``head_model_dir``; torso sweeps at steps 0
  and 16), every loss finite, a non-zero gradient in both torso groups,
  every head parameter bit-identical afterwards, and one step checked
  against the CPU plain path on 4,096 rays;
- speech to video (``audio_serve``): a seeded 8 s voiced wav through
  ``PostnetInfer.infer`` (HuBERT-large, the VAE's prior and flow, the
  post-net → the lm3d ``.npy``), then 4 head+torso frames of the torso
  checkpoint through ``RADNeRFInfer.render_frames`` driven by that lm3d
  with the LLE projection on; HuBERT, VAE, post-net, the LLE'd conditions
  and a frame held against the CPU plain path on the card's inputs; each
  stage timed, and the LLE alone against a 6,000-row database;
- stage A's training (``audio_train``): a synthetic LRS3 store written
  with the port's builder (320 + 16 clips of 40–150 frames, the reference
  binarizer's schema, ~250 MB), then ``Trainer.fit`` on the shipped
  configs: SyncNet 8 steps (64 mined clips per step), the VAE 8 steps on
  that run, the post-net 8 steps (discriminator every step) on both, the
  pitch VAE 4 steps and the pitch post-net 4 steps on it, each with a
  validation; the frozen upstreams bit-identical and equal to their
  checkpoints; one step of each task on 16 clips held against the CPU
  plain path with the same clips and noise (loss rel 1e-5, gradients 1e-4
  relative L2; the CPU replays the card's ReLU decisions); ms/step, device
  busy and idle share and the ``gf::syncnet``/``gf::vae``/
  ``gf::postnet_gen``/``gf::postnet_disc`` spans per task; then
  ``PostnetInfer`` of the 8 s wav from the trained VAE and post-net, held
  card vs CPU;
- head training through the lip phase (``train_lip``): the training cell
  with ``finetune_lips`` from step 4 (64² lip patches, LPIPS at seeded
  weights, ``lambda_lpips_loss`` 0.01) for 12 ``train_step`` calls, the lip
  steps and sweeps where the JAX task puts them, every loss finite, a
  non-zero gradient in every group on a lip step, the occupancy frozen in
  the phase, one lip step held against the CPU plain path and LPIPS alone
  card vs CPU; then ``Trainer.fit`` to step 4 and a fresh ``Trainer``
  resumed to step 6 on the card, its optimizer state and ``task_step``
  bit-identical to the checkpoint's, with the best checkpoint and each
  validation's 512² val frame written;
- a GeneFace checkpoint (``import_serve``): a reference-format torso
  checkpoint authored at full width under the keys of
  ``egs/datasets/videos/May/lm3d_radnerf_import.yaml`` (16 levels × 2),
  imported through ``utils/torch_import.py``, then 4 head+torso frames
  through ``RADNeRFInfer`` (the reference grid, the walk and the padded
  slab, with the cull) and 4 more under ``grid_backend: block``, each
  backend's frame held against the CPU plain path, and
  ``tools/validate_import`` on the checkpoint;
- its fine-tune (``import_train``): the checkpoint's head imported again,
  restored into ``RADNeRFTask`` at its step, 20 steps of 65,536 rays under
  the import config (sweeps at steps 0 and 16), every loss finite, every
  group's gradient non-zero, one step held against the CPU plain path;
- a person's dataset (``datagen``): a seeded 3DMM at BFM09's front widths
  (35,709 vertices, 70,789 triangles, id/exp/tex 80/64/80), a 100-frame
  512² video of it planted on the card at known parameters and a 4 s wav,
  through ``process_frames`` (mel, f0, HuBERT-large; BiSeNet at seeded
  weights as ``parse_fn``; the planted landmarks as ``lm_fn``;
  ``fit_sequence`` and ``refine_photometric`` at their defaults: 11
  focals × 300 steps, 700 joint steps, 150 + 2 × 80 photometric steps of
  50 frames on the soft splat, whose normals and splat run on K1 and their
  backward on K8), FAN at seeded weights on every frame,
  ``extract_3dmm_coeffs`` (ResNet-50, batches of 32) and
  ``binarize_video``; the store loaded and 2 ``RADNeRFTask`` steps on it;
  the networks, the splat, one photometric gradient and the focal search
  held against the CPU plain path on the card's inputs; ms/frame of
  parse, FAN and recon, the fit's and the refinement's seconds, the
  photometric step's idle share (``smoke_out/datagen_photo_step_profile.txt``)
  and the ``gf::parse/fan/track/photo/recon`` spans;
- the vanilla NeRF serving (``nerf_serve``): seeded ``Lm3dNeRF`` and
  ``ADNeRFTorso`` checkpoints at the shipped widths (backbones 256 wide, 64
  + 128 samples), ``LM3dNeRFInfer.run`` of a seeded predicted lm3d through
  the clean-up to 2 head frames and then 2 head+torso frames at 512² with
  their mp4s; ms/frame, the device time by stage (backbone products,
  ``freq_encode``, composite, ``sample_pdf`` with its sort), the idle
  share, and a 1,024-ray chunk of each held against the CPU on the card's
  fine samples;
- the vanilla NeRF training (``nerf_train``): 8 ``Lm3dNeRFTask`` steps of
  1,600 rays (the attention from step 3), then 6 ``Lm3dNeRFTorsoTask``
  steps on that head, the head bit-identical afterwards; ms/step, rays/s,
  the idle share, and one step of each on 256 rays held against the CPU on
  the card's draws, fine samples and ReLU decisions. Neither path launches
  K1 or K8, and the script checks that too;
- the ASR conditions (``asr``): the seeded 8 s wav through the MFCC rows
  (host), DeepSpeech v0.1.0 at full width (494 → 2048 → 2048 → 2048, an
  LSTM kernel ``[4096, 8192]``, 2048 → 29; a GraphDef ``.pb`` of 180 MiB
  the script authors) with ``extract_deepspeech_features`` → ``[200, 16,
  29]``, the esperanto wav2vec2 at xlsr-large's widths (a converted
  checkpoint, vocab 44) with ``extract_esperanto_features`` → ``[200, 16,
  44]``, and ``StreamingASR`` over the wav (context 12, strides 4/4), each
  held against the CPU; the forward's device time, the ``gf::deepspeech``
  and LSTM spans and the LSTM's bound; then the DeepSpeech windows as a
  ``.npy`` drive ``ADNeRFInfer.run`` of a seeded ``adnerf.yaml`` head to 2
  frames at 512² with the mp4;
- audio2pose (``pose``): a store of 16 + 4 clips of 250–400 frames the
  script writes, ``Trainer.fit`` of ``Audio2PoseTask`` for 8 steps with a
  validation under ``May/audio2pose.yaml``'s keys (``audio_in_dim`` 58),
  one step held against the CPU on the card's LeakyReLU decisions, then
  ``Audio2PoseInfer.infer`` of the ``asr`` path's windows → c2w ``[200,
  4, 4]`` held against the CPU, with ms per rolled frame and launches per
  frame. Neither path launches K1 or K8, and the script checks that.

It builds every CUDA kernel from ``csrc/`` (one ``nvcc`` per source, and
``g++`` for the host library, started together), sets the launch counts
to 0 before each path and checks after it
that the path launched each kernel at every call site, then holds every
kernel against its plain PyTorch version on the arguments captured at each
call site of a real frame, step and sweep of each path (a grid site is
named by the grid that owns its table: ``pos``, ``ambient`` or ``torso``),
and times kernel, plain version and library call there. At a scatter-add
site every kernel variant that takes the site's shape is held to the plain
version and timed in turns; the run fails if the wrapper's own choice is
slower than another variant by more than 10% and 2 µs.

Prints, before the last line: the card's name and power limit, each
kernel's registers, spills and static shared memory (ptxas), ms/frame,
ms/step, the sweep's ms, rays/s, the capacities, the device time by stage
and the idle share of a frame and of a step of each path
(``torch.profiler``; the tables go to ``smoke_out/``), the losses, one line
per kernel call site (the variant chosen and every variant's time, the
bound, the plain version and the library call; a reference or block grid
site is named by grid, level and backend), and one ``{"kernels": [...]}``
JSON line listing every site of the fifteen paths.
Kernel times (``ms``, ``plain_ms``, ``library_ms``) are device times from
the profiler (kernels, copies and fills only), ``library_ms``, each
variant's and each gather's the median of three windows; ``ms_events`` adds
the host's launch gaps. The profiler keeps no device record of a window's
first five launches, so each window opens with uncounted launches of its
own; it now and then records no device activity in a window, or loses
more launches: a measurement takes up to five windows, estimates from
windows that lost launches, and falls back to CUDA events behind a queued
device sleep only when no window recorded anything (counted on the
``profiler:`` line, with the rows that lost launches); a phase profile it
cannot get is "not measured".
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
TRAIN_RAYS = 65536
TRAIN_STEPS = 20
CHECK_RAYS = 4096
#: the train_lip path: 12 steps, the lip phase from step 4, 64² patches
LIP_STEPS = 12
LIP_START = 4
LIP_PATCH = 64
#: the audio_serve path: an 8 s voiced wav at 16 kHz; the LLE percent of
#: its render (the reference's own --infer value is not in the repo: 1.0);
#: a user's landmark database (a ~4-minute video at 25 fps) for the LLE
#: timed alone
AUDIO_SECONDS = 8.0
LLE_PERCENT = 1.0
LLE_DB_ROWS = 6000
LLE_K = 10
POSTNET_YAML = "egs/datasets/videos/May/lm3d_postnet_sync.yaml"
#: H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and float32
#: (non-tensor-core) operations/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
#: profiler windows per measurement before it gives up (see :func:`profiled`),
#: and the run's count of windows, misses and times taken by CUDA events
PROFILER_TRIES = 5
#: the card's name and power limit as nvidia-smi prints them (set by main)
CARD = ""
PROFILER = {"windows": 0, "windows_without_device_time": 0, "windows_missing_launches": 0,
            "estimated_from_partial_windows": 0, "timed_by_events": 0,
            "short_rows": {}, "opening_records": {}}


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
    # the torso checkpoint: the same head, seeded torso weights, the
    # planted torso occupancy
    torso = model_from_cfg(cfg, torso=True)
    torso.reset_parameters(torch.Generator().manual_seed(seed + 1))
    torso.load_state_dict(model.state_dict(), strict=False)
    save_checkpoint(
        os.path.join(root, "work_torso", "model_ckpt_steps_0.ckpt"),
        {"state": {"params": state_dict_to_flax(torso.state_dict()), "occ": occ,
                   "torso_occ": planted_torso_occupancy(cfg["grid_size"])}, "step": 0},
    )
    return cfg


def torso_cfg(cfg: dict) -> dict:
    """The torso cells: the head config with ``base.yaml``'s torso keys, the
    torso checkpoint's work dir and the head's as ``head_model_dir``."""
    return dict(
        cfg, work_dir=os.path.join(os.path.dirname(cfg["work_dir"]), "work_torso"),
        head_model_dir=cfg["work_dir"], torso_shrink=0.8, torso_head_aware=False,
        torso_individual_embedding_dim=8, density_thresh_torso=0.01, torso_train_mode=1,
    )


def planted_torso_occupancy(grid_size: int):
    """Alpha 0.5 over the lower half of the screen (screen x > 0; the grid
    is stored ``[y, x]``) — a fresh zero grid would mask every pixel out."""
    import numpy as np

    g = np.zeros((grid_size, grid_size), np.float32)
    g[:, grid_size // 2:] = 0.5
    return g.reshape(-1), np.float32(g.mean())


def build_kernels() -> str:
    """One nvcc per ``csrc/*.cu`` and the host library's g++
    (``csrc/gf_native.cpp``), all started together."""
    from geneface_tpu_torch import kernels
    from geneface_tpu_torch.native import build as native_build
    from geneface_tpu_torch.native import load_library

    names = sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob.glob(os.path.join(kernels.CSRC_DIR, "*.cu"))
    )
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    commands = {n: (kernels.build_command(n), kernels.library_path(n)) for n in names}
    commands["gf_native"] = (native_build.build_command(native_build.SRC,
                                                         native_build.LIB + ".part"),
                             native_build.LIB)
    procs = {
        n: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n, (cmd, _) in commands.items()
    }
    log = []
    for n, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"the build of {n} failed:\n{out}")
        os.replace(commands[n][1] + ".part", commands[n][1])
        log.append(f"== {n}\n{out}")
    for n in names:
        kernels.load_kernel(n)
    load_library()
    return "\n".join(log)


def host_ms(fn, n: int = 5) -> float:
    """Median host-clock ms of ``fn()`` to a synchronize, over ``n`` runs."""
    import torch

    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - ts) * 1e3)
    return sorted(out)[n // 2]


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


#: torch 2.11's profiler on the card keeps no device record of the first
#: launches of most windows (the launches it misses are the window's first
#: by host order; seen in every kind of window): five in most runs, in some
#: all of eight opening launches and about two more (half of 4,291 windows
#: of one run on an H100 80GB HBM3 at 700 W): each window opens with this
#: many ``torch.cuda._sleep`` launches, left out of its rows
PAD_LAUNCHES = 16


def _open_window() -> None:
    import torch

    for _ in range(PAD_LAUNCHES):
        torch.cuda._sleep(1)


def _device_events(prof) -> list:
    """``(name, device µs, count)`` of each kernel, copy and fill that the
    window recorded, summed by name: not the ranges that the profiler also
    places on the device timeline (the ``gf::`` stages, the optimizer's
    ``Optimizer.step#...``), which would count their kernels twice, nor the
    window's opening ``spin_kernel`` launches."""
    from torch.autograd import DeviceType

    rows = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if (e.device_type() == DeviceType.CPU or name.startswith(("gf::", "Optimizer."))
                or "spin_kernel" in name):
            continue
        us, n = rows.get(name, (0.0, 0))
        rows[name] = (us + e.duration_ns() / 1e3, n + 1)
    return [(name, us, n) for name, (us, n) in rows.items()]


def profiled(run, activities):
    """``torch.profiler`` over ``run()``: the first of up to
    ``PROFILER_TRIES`` windows that recorded device activity, else ``None``.
    The profiler now and then hands back a window without its device
    activity, at times several in a row (seen on the card for kernels and
    library calls alike); ``PROFILER`` counts the windows and the misses."""
    import torch
    from torch.profiler import profile

    for _ in range(PROFILER_TRIES):
        with profile(activities=activities) as prof:
            _open_window()
            run()
            torch.cuda.synchronize()
        PROFILER["windows"] += 1
        if any(us > 0 for _, us, _ in _device_events(prof)):
            return prof
        PROFILER["windows_without_device_time"] += 1
    return None


def queued_events_ms(fn, iters: int = 20) -> float:
    """Mean time of ``fn()`` between CUDA events over ``iters`` runs queued
    behind a ~30 ms device sleep, so that the host's launch gaps do not
    count: device time plus the device's own gaps between kernels."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int | None = None) -> float:
    """Mean device time of ``fn()`` (the sum of the kernels, copies and
    fills it runs, from ``torch.profiler``) over ``iters`` runs: by default
    20, fewer for a call that takes longer than half a millisecond (about
    10 ms of calls per window, at least 3; the scatter variants that lose
    at a 2-wide site run for 3–7 ms).

    Each window opens with :func:`_open_window`'s launches, which the
    profiler may drop unseen (``PROFILER["opening_records"]`` counts the
    windows by how many of them it recorded). A window counts whole when each kernel, copy
    and fill came a multiple of ``iters`` times. When none of
    ``PROFILER_TRIES`` windows is whole,
    each one's mean over the launches the windows did record is multiplied
    by its launches per call (the most any window recorded, rounded up to a
    multiple of ``iters``), and ``PROFILER["short_rows"]`` counts, by name,
    the windows that lost launches and the launches lost. Only when no
    window recorded device activity at all, the time of
    :func:`queued_events_ms` (device time plus the device's gaps).
    ``PROFILER`` counts each case."""
    import collections
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    if iters is None:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        iters = max(3, min(20, int(0.010 / max(time.perf_counter() - t, 1e-6))))
    time_us, launches, most = (collections.Counter() for _ in range(3))
    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _open_window()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        PROFILER["windows"] += 1
        opened = str(sum("spin_kernel" in e.name() for e in prof.profiler.kineto_results.events()))
        PROFILER["opening_records"][opened] = PROFILER["opening_records"].get(opened, 0) + 1
        rows = _device_events(prof)
        if not any(us > 0 for _, us, _ in rows):
            PROFILER["windows_without_device_time"] += 1
            continue
        short = [(name, n) for name, _, n in rows if n % iters]
        if not short:
            return sum(us for _, us, _ in rows) / 1e3 / iters
        PROFILER["windows_missing_launches"] += 1
        for name, n in short:
            lost = PROFILER["short_rows"].setdefault(name[:80], [0, 0])
            lost[0] += 1
            lost[1] += -n % iters
        for name, us, n in rows:
            time_us[name] += us
            launches[name] += n
            most[name] = max(most[name], n)
    if not launches:
        PROFILER["timed_by_events"] += 1
        return queued_events_ms(fn, iters)
    PROFILER["estimated_from_partial_windows"] += 1
    return sum(time_us[k] / launches[k] * math.ceil(most[k] / iters) for k in launches) / 1e3


def _wrapper_patches():
    """(module, attribute, call site kind) of every kernel wrapper the main
    path calls through a module global."""
    from geneface_tpu_torch.ops import encoders, fused_grid, scatter

    return [
        (fused_grid, "launch_gather_rows", "grid_forward"),
        (fused_grid, "launch_scatter_add_rows", "grid_backward"),
        (encoders, "launch_gather_rows", "gather_rows"),
        (encoders, "launch_scatter_add_rows", "scatter_add_rows"),
        (scatter, "launch_scatter_add_rows", "scatter_add_rows"),
        (scatter, "launch_gather_rows", "gather_rows"),
    ]


def capture_calls(run) -> list:
    """``(kind, args, owner, kwargs)`` of every kernel call that ``run()``
    makes, with the tensor arguments cloned, in call order. ``owner`` is ``(id(fused
    grid meta), group)`` for the fused grid's calls (read from the calling
    frame of ``ops/fused_grid.py``), else from the calling frame's ``site``:
    ``("level", id(grid meta), level, backend)`` for the reference and
    block grids', ``("named", name)`` for the renderer's scatters (and
    their backward gathers), ``("clip", name)`` for stage A's clip gathers
    (and their backward scatter-adds), ``("datagen", name)`` for the
    datagen renderer's normals and splat (and their backward gathers)."""
    import torch

    calls = []
    patches = _wrapper_patches()
    reals = [getattr(mod, name) for mod, name, _ in patches]

    def recorder(real, kind):
        def call(*args, **kw):
            caller = sys._getframe(1).f_locals
            site = caller.get("site")
            if kind.startswith("grid"):
                owner = (id(caller["fmeta"]), caller["gi"])
            elif isinstance(site, str):  # the renderer's named scatters
                owner = ("named", site)
            elif site[0] in ("clip", "datagen"):  # stage A's clip gathers (and their
                owner = site  # adjoint), the datagen renderer's scatters (and theirs)
            else:  # a reference or block grid level
                owner = ("level", id(site[0]), site[1], site[2])
            calls.append((kind, tuple(a.clone() if torch.is_tensor(a) else a for a in args),
                          owner, kw))
            return real(*args, **kw)

        return call

    for (mod, name, kind), real in zip(patches, reals):
        setattr(mod, name, recorder(real, kind))
    try:
        run()
    finally:
        for (mod, name, _), real in zip(patches, reals):
            setattr(mod, name, real)
    return calls


def median_ms(fn, windows: int = 3) -> float:
    """Median of ``windows`` :func:`device_ms` windows of ``fn``."""
    return sorted(device_ms(fn) for _ in range(windows))[windows // 2]


def measure_scatter(rows, updates, n_rows, exact: bool, spread: bool = False) -> dict:
    """K1 on one captured call: every variant that takes the shape held
    against the plain version, then timed in turns (three rounds over the
    variants and ``index_add_``, the median of each); ``spread`` as the
    call passed it to the dispatcher."""
    import torch

    from geneface_tpu_torch.ops import scatter as sc

    M, W = updates.shape
    shape = (M, W, int(n_rows), updates.element_size(), updates.data_ptr() % 16 == 0)
    chosen = sc.pick_scatter_variant(*shape, spread=spread)
    accepted = [v for v in sc.VARIANTS if sc.scatter_variant_accepts(v, *shape)]
    if chosen not in accepted:
        raise AssertionError(f"the dispatcher chose {chosen}, which does not take {shape}")
    ref = sc.scatter_add_rows_plain(rows, updates, n_rows)
    kept = (rows >= 0) & (rows < n_rows)
    # float32 sums of the same terms in two orders: each sum of n terms is
    # held to the first-order bound of both orders' rounding, 2·n·2^-24
    # times the sum of its terms' magnitudes (the grid backward sums up to
    # ~2,000 cancelling terms per row)
    n = torch.bincount(rows[kept].long(), minlength=n_rows).float()[:, None]
    bound = 2.0 * n * 2.0**-24 * sc.scatter_add_rows_plain(rows, updates.abs(), n_rows)
    errs = {}
    for v in accepted:
        got = sc.launch_scatter_add_rows(rows, updates, n_rows, variant=v)
        torch.cuda.synchronize()
        errs[v] = float((got - ref).abs().max()) if got.numel() else 0.0
        if exact and errs[v] != 0.0:
            raise AssertionError(f"scatter ({v}) with unique rows not exact: {errs[v]}")
        bad = int(((got - ref).abs() > bound).sum())
        if bad:
            raise AssertionError(f"scatter ({v}): {bad} sums beyond the float32 rounding bound")
    n_kept = int(kept.sum())
    # the library yardstick: one index_add_ on in-range rows (redirected to
    # a spill row outside the timed call)
    safe = torch.where(kept, rows, n_rows).long()
    upd32 = updates.float()

    def library():
        return torch.zeros(n_rows + 1, W, device=updates.device).index_add_(0, safe, upd32)

    def kernel(v=None):
        return lambda: sc.launch_scatter_add_rows(rows, updates, n_rows, variant=v)

    rounds = {v: [] for v in accepted + ["library"]}
    for _ in range(3):
        for v in accepted:
            rounds[v].append(device_ms(kernel(v)))
        rounds["library"].append(device_ms(library))
    times = {v: sorted(t)[1] for v, t in rounds.items()}
    n_bytes = M * 4 + n_kept * W * updates.element_size() + n_rows * W * 4
    n_ops = n_kept * W
    return {
        "M": M, "W": W, "n_rows": int(n_rows), "kept_rows": n_kept,
        "variant": chosen, "max_abs_err": errs[chosen], "ms": times[chosen],
        "variants": {v: times[v] for v in accepted},
        "variants_max_abs_err": errs,
        "plain_ms": device_ms(lambda: sc.scatter_add_rows_plain(rows, updates, n_rows)),
        "library_ms": times["library"],
        "ms_events": events_ms(kernel()),
        "bytes_ms": n_bytes / PEAK_BYTES_S * 1e3,
        "ops_ms": n_ops / PEAK_F32_OPS_S * 1e3,
    }


def misdispatched(site: dict) -> str | None:
    """A message if another variant that takes the site's shape beat the
    dispatcher's choice by more than 10% and 2 µs."""
    best = min(site["variants"], key=site["variants"].get)
    ms, best_ms = site["ms"], site["variants"][best]
    if ms > 1.1 * best_ms and ms - best_ms > 0.002:
        return (f"{site['site']}: pick_scatter_variant chose {site['variant']} "
                f"({ms:.4f} ms) but {best} takes {best_ms:.4f} ms")
    return None


def measure_gather(table, idx) -> dict:
    """K8 vs its plain version vs ``index_select`` on one captured call (a
    copy: the result must be exact)."""
    import torch

    from geneface_tpu_torch.ops import gather as ga

    got = ga.launch_gather_rows(table, idx)
    ref = ga.gather_rows_plain(table, idx)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    if err != 0.0:
        raise AssertionError(f"row gather not exact: {err}")
    R, W = table.shape
    M = idx.shape[0]
    keep = (idx >= 0) & (idx < R)
    # the library yardstick: one index_select of the float32 table, with
    # out-of-range indices sent to an appended zero row outside the timed call
    padded = torch.cat([table, torch.zeros(1, W, dtype=table.dtype, device=table.device)])
    safe = torch.where(keep, idx, R).long()

    def library():
        return padded.float().index_select(0, safe)

    def kernel():
        return ga.launch_gather_rows(table, idx)

    # the kernel and the library call timed in turns, the median of three each
    rounds = {"kernel": [], "library": []}
    for _ in range(3):
        rounds["kernel"].append(device_ms(kernel))
        rounds["library"].append(device_ms(library))
    # the rows this call must read: each distinct in-range row once (a clip
    # gather reads 640 of a batch's ~77,000 HuBERT rows)
    n_read = int(torch.unique(idx[keep]).numel())
    n_bytes = M * 4 + n_read * W * table.element_size() + M * W * 4
    return {
        "M": M, "W": W, "n_rows": R, "kept_rows": int(keep.sum()), "rows_read": n_read,
        "max_abs_err": err,
        "columns_per_thread": ga.pick_gather_path(
            W, table.element_size(), table.data_ptr(), got.data_ptr()),
        "ms": sorted(rounds["kernel"])[1],
        "plain_ms": device_ms(lambda: ga.gather_rows_plain(table, idx)),
        "library_ms": sorted(rounds["library"])[1],
        "ms_events": events_ms(kernel),
        "bytes_ms": n_bytes / PEAK_BYTES_S * 1e3,
        "ops_ms": 0.0,
    }


def grid_names(model) -> dict:
    """``id(grid meta)`` (fused, level and block metas) → the grid that owns
    the tables: ``pos``, ``ambient`` and, for the torso model, ``torso``
    (the torso grid's tables have the ambient grid's shapes)."""
    out = {}
    for name in ("pos", "ambient", "torso"):
        for kind in ("fused", "grid", "block"):
            meta = getattr(model, f"{name}_{kind}_meta", None)
            if meta is not None:
                out[id(meta)] = name
    return out


def name_sites(calls, grids: dict, path: str) -> dict:
    """First captured call of each distinct site of one path → ``{site:
    (kernel, kind, args, kwargs)}``; grid sites are named by the grid and group (or
    level and backend) that own the table, the renderer's scatters by their
    label."""
    sites = {}
    for kind, args, owner, kw in calls:
        if owner[0] == "datagen":  # the face renderer's scatters, or their adjoint
            scatter = kind == "scatter_add_rows"
            site = f"{path}.{owner[1]}" + ("" if scatter else ".backward_gather")
            kernel = "scatter_add_rows" if scatter else "gather_rows"
        elif owner[0] == "clip":  # a clip gather over a batch's rows, or its adjoint
            gather = kind == "gather_rows"
            site = f"{path}.{owner[1]}.{'forward_gather' if gather else 'backward_scatter'}"
            kernel = "gather_rows" if gather else "scatter_add_rows"
        elif owner[0] == "level":  # a reference / block grid level
            _, meta_id, lvl, backend = owner
            gather = kind == "gather_rows"
            step = "forward_gather" if gather else "backward_scatter"
            site = f"{path}.{grids[meta_id]}.level_{lvl}.{backend}.{step}"
            kernel = "gather_rows" if gather else "scatter_add_rows"
        elif kind == "grid_forward":
            site = f"{path}.{grids[owner[0]]}.group_{owner[1]}.forward_gather"
            kernel = "gather_rows"
        elif kind == "grid_backward":
            site = f"{path}.{grids[owner[0]]}.group_{owner[1]}.backward_scatter"
            kernel = "scatter_add_rows"
        elif kind == "scatter_add_rows":
            site = f"{path}.{owner[1]}"
            kernel = "scatter_add_rows"
        else:
            site = f"{path}.{owner[1]}.backward_gather"
            kernel = "gather_rows"
        sites.setdefault(site, (kernel, kind, args, kw))
    return sites


def measure_sites(sites: dict, per_call: dict) -> list:
    """Time every site; ``per_call[site]`` = launches per step or frame."""
    out = []
    for site, (kernel, kind, args, kw) in sites.items():
        if kernel == "gather_rows":
            m = measure_gather(*args)
        else:
            exact = site.endswith("frame_scatter")
            m = measure_scatter(*args, exact=exact, **kw)
        m.update(site=site, kernel=kernel, launches_per_call=per_call.get(site, 1))
        out.append(m)
        bound = max(m["bytes_ms"], m["ops_ms"])
        how = (f"variant {m['variant']}, all " + json.dumps(
            {v: round(t, 4) for v, t in m["variants"].items()})
            if kernel == "scatter_add_rows" else f"{m['columns_per_thread']} columns per thread")
        print(f"site {site} [{m['M']}, {m['W']}] x [{m['n_rows']}, {m['W']}]: {kernel} "
              f"{m['ms']:.4f} ms ({how}); bound {bound:.4f}, plain {m['plain_ms']:.4f}, "
              f"library {m['library_ms']:.4f}")
    wrong = [w for w in (misdispatched(m) for m in out if "variants" in m) if w]
    if wrong:
        raise AssertionError("the dispatcher's table is wrong: " + "; ".join(wrong))
    behind = [f"{m['site']} {m['ms']:.4f} ms vs {m['library_ms']:.4f}" for m in out
              if m["ms"] > 1.1 * m["library_ms"] and m["ms"] - m["library_ms"] > 0.002]
    print(f"sites behind their library call by more than 10% and 2 µs: {len(behind)} "
          + json.dumps(behind))
    return out


def ptxas_summary(build_log: str) -> dict:
    """``{kernel: {"registers", "spill_bytes", "static_smem_bytes"}}``, the
    most over a kernel's instantiations, from nvcc's ``-Xptxas -v`` output."""
    import re

    out, name = {}, None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            # the mangled name holds each identifier behind its length; the
            # last such match is the kernel (a hash before it may match too)
            found = re.finditer(r"(?=(\d{1,2})([a-z][a-z0-9_]*?_kernel))", line)
            name = [m.group(2) for m in found if int(m.group(1)) == len(m.group(2))][-1]
            out.setdefault(name, {"registers": 0, "spill_bytes": 0, "static_smem_bytes": 0})
            continue
        if name is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        used = re.search(r"Used (\d+) registers", line)
        smem = re.search(r"(\d+) bytes smem", line)
        k = out[name]
        if spill:
            k["spill_bytes"] = max(k["spill_bytes"], int(spill.group(1)) + int(spill.group(2)))
        if used:
            k["registers"] = max(k["registers"], int(used.group(1)))
            k["static_smem_bytes"] = max(k["static_smem_bytes"], int(smem.group(1)) if smem else 0)
    return out


def kernel_entry(name: str, sites: list, launches: dict, ptxas: dict) -> dict:
    """One kernel's line of the ``kernels`` JSON: its times summed over one
    call at every site, launches of the counted serve and train runs."""
    mine = [s for s in sites if s["kernel"] == name]
    bytes_ms = sum(s["bytes_ms"] for s in mine)
    ops_ms = sum(s["ops_ms"] for s in mine)
    meta = {
        "scatter_add_rows": ("geneface_tpu_torch/csrc/scatter_add_rows.cu",
                             "geneface_tpu/ops/pallas_scatter.py:79"),
        "gather_rows": ("geneface_tpu_torch/csrc/gather_rows.cu",
                        "tools/bench_pallas_scatter2.py:67"),
    }[name]
    return {
        "name": name, "route": "cuda", "source": meta[0], "replaces": meta[1],
        "launches": sum(v[name] for v in launches.values()),
        "launches_by_path": {k: v[name] for k, v in launches.items()},
        "max_abs_err": max(s["max_abs_err"] for s in mine),
        "ms": sum(s["ms"] for s in mine),
        "plain_ms": sum(s["plain_ms"] for s in mine),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": sum(s["library_ms"] for s in mine),
        "ms_events": sum(s["ms_events"] for s in mine),
        "bytes_ms": bytes_ms,
        "sum_of": "one call at each site below",
        "ptxas": {k: v for k, v in ptxas.items()
                  if k.startswith("gather") == (name == "gather_rows")},
        "sites": mine,
    }


def profile_frame(infer, out_dir: str, steady_ms: float, path: str = "serve",
                  conds=None) -> dict:
    """Device time of one steady frame by kernel, and the device-timeline
    span of each renderer stage (``gf::*`` ranges: its kernels plus the gaps
    between them), from ``torch.profiler``; the table goes to
    ``out_dir/<path>_frame_profile.txt``. The idle share compares the
    kernels' sum with the unprofiled frame's wall time ``steady_ms``."""
    import torch
    from torch.profiler import ProfilerActivity

    infer.render_frame(0, conds)
    torch.cuda.synchronize()
    prof = profiled(lambda: infer.render_frame(0, conds),
                    [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    kernels, stages, busy = kernel_table(prof)
    with open(os.path.join(out_dir, f"{path}_frame_profile.txt"), "w") as f:
        f.write(f"steady wall {steady_ms:.3f} ms, device busy {fmt_ms(busy, ' ms')}\n")
        for name, ms in sorted(stages.items(), key=lambda s: -s[1]):
            f.write(f"stage {name:24s} {ms:9.3f} ms\n")
        for name, ms, n in kernels:
            f.write(f"{ms:9.3f} ms {n:5d}x {name}\n")
    return {"steady_ms": steady_ms, "device_busy_ms": busy,
            "idle_share": None if busy is None else max(0.0, 1.0 - busy / steady_ms),
            "stages_ms": stages,
            "top_kernels": [[k[0][:100], k[1], k[2]] for k in kernels[:12]]}


def kernel_table(prof) -> tuple:
    """(kernels as ``(name, device ms, count)`` slowest first, ``gf::``
    stage spans in ms, device busy ms) of a profiled window; a window that
    :func:`profiled` could not get gives ``([], {}, None)``: not measured."""
    if prof is None:
        return [], {}, None
    kernels = sorted(((name, us / 1e3, n) for name, us, n in _device_events(prof)),
                     key=lambda k: -k[1])
    stages = {e.key: e.device_time_total / 1e3
              for e in prof.key_averages() if e.key.startswith("gf::")}
    return kernels, stages, sum(k[1] for k in kernels)


def fmt_ms(x, unit: str = "") -> str:
    return "not measured" if x is None else f"{x:.3f}{unit}"


def n_grid_groups(model) -> tuple:
    """(head, torso) row gathers of one grid encode: the fused grids' groups,
    or the levels of the reference and block grids."""
    if model.grid_backend == "fused":
        head = len(model.pos_fused_meta.groups) + len(model.ambient_fused_meta.groups)
        torso = len(model.torso_fused_meta.groups) if hasattr(model, "torso_fused_meta") else 0
    else:
        head = model.pos_grid_meta.num_levels + model.ambient_grid_meta.num_levels
        torso = model.torso_grid_meta.num_levels if hasattr(model, "torso_grid_meta") else 0
    return head, torso


def serve_phase(cfg, out_dir: str, path: str = "serve") -> tuple:
    """A serving path: 4 frames through ``RADNeRFInfer.render_frames`` (the
    head's checkpoint, or with ``cfg`` from :func:`torso_cfg` the torso's),
    checked against the CPU plain path; → (record, launches, sites)."""
    import numpy as np
    import torch

    from geneface_tpu_torch.inference import RADNeRFInfer
    from geneface_tpu_torch.kernels import LAUNCHES

    infer = RADNeRFInfer(cfg)  # cuda, bf16 head MLPs
    # warm-up (first launches, allocator), then the counted main path
    infer.render_frames(1)
    torch.cuda.synchronize()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t1 = time.perf_counter()
    frames = infer.render_frames(RENDER_FRAMES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(LAUNCHES)

    if frames.shape != (RENDER_FRAMES, HW, HW, 3) or frames.dtype != np.uint8:
        raise AssertionError(f"{path}: frames {frames.shape} {frames.dtype}")
    # per frame: the composite sums (the compact path; the padded slab's
    # composite is no scatter) and, with the ray cull, the frame scatter
    # (K1); one row gather per grid group (fused) or level of the head and
    # the torso (K8)
    compact = bool(infer.render_kwargs["mean_samples_per_ray"])
    per_frame = int(compact) + int(bool(infer.ray_capacity))
    want = {"scatter_add_rows": per_frame * RENDER_FRAMES,
            "gather_rows": sum(n_grid_groups(infer.model)) * RENDER_FRAMES}
    if launches != want:
        raise AssertionError(f"{path} launches {launches}, expected {want}")
    last = infer.last_render
    if not torch.isfinite(last["rgb_map"]).all():
        raise AssertionError(f"{path}: non-finite pixels")
    item = infer.dataset[RENDER_FRAMES - 1]
    rgb = last["rgb_map"]
    if infer.torso:
        # the head over the torso-over-background, and that over the plain
        # background inside the torso mask
        bg = torch.as_tensor(item["bg_img"], device=infer.device)
        torso_bg = last["torso_rgb_map"]
        shown = {"head": float((rgb - torso_bg).abs().max()),
                 "torso": float((torso_bg - bg).abs()[infer.torso_mask].max())}
        print(f"{path}: torso mask covers {int(infer.torso_mask.sum())} of {HW * HW} pixels; "
              f"largest difference, head over torso+background and torso over "
              f"background: {json.dumps(shown)}")
        if min(shown.values()) < 0.02:
            raise AssertionError(f"{path}: the head or the torso does not show: {shown}")
    else:
        bg = torch.as_tensor(item["bg_torso_img"], device=infer.device)
        if float((rgb - bg).abs().max()) < 0.02:
            raise AssertionError("the head does not show against the background")

    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        infer.render_frame(0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - ts) * 1e3)
    C = infer.ray_capacity or HW * HW
    # the compact path's sample capacity, or the padded slab's every slot
    Mc = (-(-C * int(cfg["mean_samples_per_ray"]) // 1024) * 1024 if compact
          else C * infer.render_kwargs["max_steps"])
    n_samples = last["n_samples"].float()
    print(f"{path}: ms/frame {wall / RENDER_FRAMES * 1e3:.3f} (render_frames of "
          f"{RENDER_FRAMES}, per-video set-up included); steady render_frame "
          f"median {sorted(times)[2]:.3f} ms")
    print(f"{path}: ray capacity C={C}, {'sample capacity' if compact else 'padded slab'} "
          f"Mc={Mc}, mean samples/ray {float(n_samples.mean()):.3f} over the C rendered rays "
          f"(hit rays: {int((n_samples > 0).sum())})")

    # frame vs the port's plain CPU path (same checkpoint, same dtype)
    cpu = RADNeRFInfer(cfg, device="cpu")
    cpu.prepare()
    if cpu.ray_capacity != infer.ray_capacity:
        raise AssertionError(f"{path}: capacity {cpu.ray_capacity} on CPU vs {C}")
    ref = cpu.render_frame(0)["rgb_map"]
    gpu = infer.render_frame(0)["rgb_map"].cpu()
    diff = (gpu - ref).abs()
    print(f"{path}: frame 0 vs CPU plain path: max abs {float(diff.max()):.3e}, "
          f"mean abs {float(diff.mean()):.3e}")
    # bf16 MLPs on both sides: a hidden unit may round the other way
    if float(diff.max()) > 1e-3 or float(diff.mean()) > 1e-6:
        raise AssertionError(f"{path}: GPU frame disagrees with the CPU plain path")

    calls = capture_calls(lambda: infer.render_frame(0))
    sites = name_sites(calls, grid_names(infer.model), path)
    prof = profile_frame(infer, out_dir, sorted(times)[2], path)
    print(f"{path}: frame device time {fmt_ms(prof['device_busy_ms'], ' ms')} of "
          f"{prof['steady_ms']:.3f} ms wall (idle share {fmt_ms(prof['idle_share'])}); "
          "stages ms " + json.dumps({k: round(v, 3) for k, v in prof["stages_ms"].items()}))
    record = {"ms_per_frame": wall / RENDER_FRAMES * 1e3, "steady_ms": times,
              "ray_capacity": C, "sample_capacity": Mc, "profile": prof,
              "frame_vs_cpu_max_abs": float(diff.max())}
    return record, launches, sites


def write_voiced_wav(path: str, seconds: float, seed: int = 0) -> None:
    """A 16 kHz mono int16 wav: five harmonics on an f0 contour between 120
    and 220 Hz, plus noise, so that ``extract_f0`` finds voiced frames."""
    import numpy as np
    from scipy.io import wavfile

    rng = np.random.RandomState(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    f0 = 170 + 50 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 16000
    x = sum(np.sin(h * phase) / h for h in range(1, 6)) * 0.3 + 0.02 * rng.randn(len(t))
    wavfile.write(path, 16000, (x * 0.8 * 32767 / np.abs(x).max()).astype(np.int16))


def write_audio_models(root: str, seed: int = 0) -> dict:
    """The wav and the stage-A checkpoints in the JAX layout, as a user's
    would be: HuBERT-large (``{"config", "params"}`` at the path
    ``GF_HUBERT_CKPT`` names), ``VAEModel(204)`` and ``CNNPostNet(204)`` in
    ``model_ckpt_steps_0.ckpt`` of their work dirs; every weight from a
    seeded generator (the flow's output convs too, which flax initializes
    to zero)."""
    import dataclasses

    import torch

    from geneface_tpu_torch.convert import flax_variables
    from geneface_tpu_torch.datagen.wav2vec2 import Wav2Vec2Config, Wav2Vec2CTC
    from geneface_tpu_torch.models.audio2motion.vae import VAEModel
    from geneface_tpu_torch.models.layers import init_weights_
    from geneface_tpu_torch.models.postnet.models import CNNPostNet
    from geneface_tpu_torch.utils.checkpoint import save_checkpoint

    os.makedirs(root, exist_ok=True)
    gen = torch.Generator().manual_seed(seed)
    files = {"wav": os.path.join(root, "speech.wav"), "hubert": os.path.join(root, "hubert.pkl"),
             "vae": os.path.join(root, "lm3d_vae_sync"), "postnet": os.path.join(root, "postnet")}
    write_voiced_wav(files["wav"], AUDIO_SECONDS, seed)
    hcfg = Wav2Vec2Config(vocab_size=0)  # HuBERT-large
    hubert = init_weights_(Wav2Vec2CTC(hcfg), gen)
    save_checkpoint(files["hubert"], {"config": dataclasses.asdict(hcfg),
                                      "params": flax_variables(hubert)})
    save_checkpoint(os.path.join(files["vae"], "model_ckpt_steps_0.ckpt"),
                    {"state": {"params": flax_variables(init_weights_(VAEModel(204), gen))}})
    save_checkpoint(os.path.join(files["postnet"], "model_ckpt_steps_0.ckpt"),
                    {"state": {"gen_params": flax_variables(init_weights_(CNNPostNet(204), gen))}})
    return files


def as_float64(x):
    """A tensor (on any device) or an array → a float64 numpy array."""
    import numpy as np

    return np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.float64)


def held(name: str, got, ref, bound: float, relative: bool = True,
         path: str = "audio_serve") -> float:
    """Max abs difference of card ``got`` against CPU ``ref``, held to
    ``bound`` (times ``max |ref|`` when ``relative``) → the difference."""
    import numpy as np

    got, ref = as_float64(got), as_float64(ref)
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise AssertionError(f"{name}: card {got.shape} vs CPU {ref.shape}, or not finite")
    err = float(np.abs(got - ref).max())
    limit = bound * float(np.abs(ref).max()) if relative else bound
    print(f"{path}: {name} card vs CPU max abs {err:.3e} (bound {limit:.3e})")
    if not err <= limit:
        raise AssertionError(f"{name}: card vs CPU {err} > {limit}")
    return err


def audio_serve_phase(cfg, out_dir: str, path: str = "audio_serve") -> tuple:
    """Speech to video: an 8 s wav through stage A (``PostnetInfer.infer``:
    HuBERT-large, the VAE's prior and flow, the post-net → lm3d ``.npy``)
    and stage B (``RADNeRFInfer.render_frames`` of the torso checkpoint,
    driven by the predicted lm3d with the LLE projection on); every stage
    held against the port's plain CPU path on the card's inputs; the LLE
    timed alone at a user's database size; → (record, launches, sites)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity

    from geneface_tpu_torch import set_full_fp32
    from geneface_tpu_torch.config.config import load_config
    from geneface_tpu_torch.inference import PostnetInfer, RADNeRFInfer
    from geneface_tpu_torch.inference.audio2motion_infer import prior_noise, truncate16
    from geneface_tpu_torch.inference.landmark_postprocess import lle_project_lm3d
    from geneface_tpu_torch.kernels import LAUNCHES
    from geneface_tpu_torch.models.postnet.lle import compute_lle_projection
    from geneface_tpu_torch.utils.audio import (
        extract_f0,
        extract_hubert,
        load_hubert,
        load_wav16k,
    )

    root = os.path.join(os.path.dirname(cfg["work_dir"]), "audio")
    t0 = time.perf_counter()
    files = write_audio_models(root)
    print(f"{path}: checkpoints written in {time.perf_counter() - t0:.1f} s "
          f"(HuBERT-large {os.path.getsize(files['hubert']) / 2**20:.0f} MiB)")
    os.environ["GF_HUBERT_CKPT"] = files["hubert"]
    npy = os.path.join(root, "pred_lm3d.npy")
    pcfg = load_config(os.path.join(REPO, POSTNET_YAML), overrides={
        "audio2motion_work_dir": files["vae"], "postnet_work_dir": files["postnet"],
        "infer_audio_source_name": files["wav"], "infer_out_npy_name": npy})
    rcfg = dict(cfg, infer_lm3d_lle_percent=LLE_PERCENT)
    stage_a = PostnetInfer(pcfg)  # cuda
    render = RADNeRFInfer(rcfg)  # cuda, bf16 head MLPs
    seed = int(pcfg.get("seed", 0))

    def speech_to_frames(n_frames):
        lm = stage_a.infer(wav_path=files["wav"], out_npy=npy, seed=seed)
        return lm, render.render_frames(n_frames, idexp_lm3d=lm)

    speech_to_frames(1)  # warm-up (first launches, allocator, cuDNN)
    torch.cuda.synchronize()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t1 = time.perf_counter()
    lm3d = stage_a.infer(wav_path=files["wav"], out_npy=npy, seed=seed)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    frames = render.render_frames(RENDER_FRAMES, idexp_lm3d=lm3d)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = dict(LAUNCHES)

    n_samples = int(AUDIO_SECONDS * 16000)
    wav = load_wav16k(files["wav"])
    n_hubert = (n_samples - 400) // 320 + 1  # the conv stack's frames
    n_rows = truncate16(min(2 * n_hubert, 1 + n_samples // 160))
    if len(wav) != n_samples or lm3d.shape != (n_rows // 2, 68, 3) or not np.isfinite(lm3d).all():
        raise AssertionError(f"{path}: {len(wav)} samples → lm3d {lm3d.shape}, "
                             f"expected {(n_rows // 2, 68, 3)}, finite")
    if np.load(npy).shape != (1,) + lm3d.shape:
        raise AssertionError(f"{path}: {npy} holds {np.load(npy).shape}")
    if frames.shape != (RENDER_FRAMES, HW, HW, 3) or frames.dtype != np.uint8:
        raise AssertionError(f"{path}: frames {frames.shape} {frames.dtype}")
    per_frame = 2 if render.ray_capacity else 1
    want = {"scatter_add_rows": per_frame * RENDER_FRAMES,
            "gather_rows": sum(n_grid_groups(render.model)) * RENDER_FRAMES}
    if launches != want:
        raise AssertionError(f"{path} launches {launches}, expected {want}")
    fps = len(lm3d) / AUDIO_SECONDS
    print(f"{path}: {AUDIO_SECONDS} s of audio ({n_samples} samples) → {n_hubert} HuBERT frames "
          f"→ {n_rows} rows → {len(lm3d)} landmark frames ({fps:.2f} per second of audio); "
          f"stage A {(t2 - t1) * 1e3:.3f} ms wall (HuBERT checkpoint read included), "
          f"ms/frame {(t3 - t2) / RENDER_FRAMES * 1e3:.3f} (render_frames of {RENDER_FRAMES}, "
          f"LLE and per-video set-up included)")

    # the stages one by one: host clock for the host ops (host_ms), CUDA
    # events for the device ones (each a mean over back-to-back runs after a
    # warm-up)
    stages = {"wav_read_ms": host_ms(lambda: load_wav16k(files["wav"])),
              "f0_ms": host_ms(lambda: extract_f0(wav), n=3),
              "hubert_load_ms": host_ms(lambda: load_hubert(files["hubert"], "cuda"), n=1)}
    hmodel = load_hubert(files["hubert"], "cuda")
    hidden = extract_hubert(wav, model=hmodel)
    hubert, f0 = hidden[:n_rows], extract_f0(wav)[:n_rows]
    noise = prior_noise(stage_a.vae, n_rows // 2, seed)
    raw = stage_a.sample(hubert, f0, noise)
    conds = render.conds_from_lm3d(lm3d)
    lm_norm = ((lm3d - np.asarray(render.dataset.idexp_lm3d_mean))
               / np.asarray(render.dataset.idexp_lm3d_std))
    stages.update(
        hubert_ms=events_ms(lambda: extract_hubert(wav, model=hmodel), iters=5),
        vae_ms=events_ms(lambda: stage_a.sample(hubert, f0, noise)),
        postnet_ms=events_ms(lambda: stage_a.refine(raw, f0)),
        conds_from_lm3d_ms=host_ms(lambda: render.conds_from_lm3d(lm3d)),
        lle_on_path_ms=host_ms(lambda: lle_project_lm3d(
            lm_norm, render.dataset.conds[:, 0].reshape(-1, 68, 3), LLE_PERCENT,
            device=render.device)),
    )
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        render.render_frame(0, conds)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - ts) * 1e3)
    steady = sorted(times)[2]

    # the LLE alone at a user's database size (seeded rows, the predicted
    # landmarks as queries)
    gen = torch.Generator().manual_seed(7)
    db = torch.randn(LLE_DB_ROWS, 204, generator=gen)
    q = torch.as_tensor(conds[:, 0], dtype=torch.float32)
    db_c, q_c = db.cuda(), q.cuda()
    stages["lle_6000_ms"] = events_ms(lambda: compute_lle_projection(q_c, db_c, LLE_K))
    print(f"{path}: stage ms " + json.dumps({k: round(v, 3) for k, v in stages.items()})
          + f"; steady render_frame median {steady:.3f} ms")

    # card vs the port's plain CPU path, each stage on the card's inputs.
    # float32 everywhere (TF32 off): HuBERT's 24 layers, the VAE's and the
    # post-net's convolutions run other algorithms and sum orders on the
    # card (cuDNN, cuBLAS), ~1e-6 of the largest magnitude, so they are held
    # to 1e-5 of it; the LLE solves in float64 (1e-5 absolute on normalized
    # landmarks); the frame to the serving paths' bounds
    cpu_a = PostnetInfer(pcfg, device="cpu")
    refs = {"hubert": extract_hubert(wav, model=load_hubert(files["hubert"], "cpu")),
            "vae": cpu_a.sample(hubert, f0, noise), "postnet": cpu_a.refine(raw.cpu(), f0)}
    lm_card = stage_a.refine(raw, f0)
    errs = {"hubert": held("HuBERT hidden states", hidden, refs["hubert"], 1e-5),
            "vae": held("VAE prior sample", raw, refs["vae"], 1e-5),
            "postnet": held("post-net lm3d", lm_card, refs["postnet"], 1e-5)}
    # the same three stages with TF32 on (cuBLAS and cuDNN round their
    # operands to 10-bit mantissas): a reading, relative to max |ref|, that
    # shows whether the 1e-5 bound tells TF32 from float32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = {"hubert": extract_hubert(wav, model=hmodel),
                "vae": stage_a.sample(hubert, f0, noise), "postnet": stage_a.refine(raw, f0)}
    finally:
        set_full_fp32()
    tf32 = {k: float(np.abs(as_float64(v) - as_float64(refs[k])).max()
                     / np.abs(as_float64(refs[k])).max()) for k, v in tf32.items()}
    print(f"{path}: with TF32 on, card vs CPU max abs / max |ref| "
          + json.dumps({k: f"{v:.3e}" for k, v in tf32.items()}) + " (bound 1e-5)")
    cpu_r = RADNeRFInfer(rcfg, device="cpu")
    errs["conds"] = held("LLE'd condition windows", conds, cpu_r.conds_from_lm3d(lm3d), 1e-5,
                         relative=False)
    fused_c, _ = compute_lle_projection(q_c, db_c, LLE_K)
    fused, _ = compute_lle_projection(q, db, LLE_K)
    errs["lle_6000"] = held(f"LLE at {LLE_DB_ROWS} rows", fused_c, fused, 1e-5, relative=False)
    cpu_r.prepare()
    ref = cpu_r.render_frame(0, conds)["rgb_map"]
    gpu = render.render_frame(0, conds)["rgb_map"].cpu()
    diff = (gpu - ref).abs()
    print(f"{path}: frame 0 vs CPU plain path: max abs {float(diff.max()):.3e}, "
          f"mean abs {float(diff.mean()):.3e}")
    if float(diff.max()) > 1e-3 or float(diff.mean()) > 1e-6:
        raise AssertionError(f"{path}: GPU frame disagrees with the CPU plain path")

    # stage A on the device timeline: gf::hubert / gf::vae / gf::postnet
    def stage_a_device():
        extract_hubert(wav, model=hmodel)
        stage_a.refine(stage_a.sample(hubert, f0, noise), f0)

    wall_a = host_ms(stage_a_device, n=3)
    kernels, spans, busy = kernel_table(profiled(stage_a_device,
                                                 [ProfilerActivity.CPU, ProfilerActivity.CUDA]))
    with open(os.path.join(out_dir, f"{path}_stage_a_profile.txt"), "w") as f:
        f.write(f"stage A (HuBERT forward, VAE, post-net) wall {wall_a:.3f} ms, "
                f"device busy {fmt_ms(busy, ' ms')}\n")
        for name, ms in sorted(spans.items(), key=lambda x: -x[1]):
            f.write(f"stage {name:24s} {ms:9.3f} ms\n")
        for name, ms, n in kernels:
            f.write(f"{ms:9.3f} ms {n:5d}x {name}\n")
    idle_a = None if busy is None else max(0.0, 1.0 - busy / wall_a)
    print(f"{path}: stage A device time {fmt_ms(busy, ' ms')} of {wall_a:.3f} ms wall (idle "
          f"share {fmt_ms(idle_a)}); spans ms "
          + json.dumps({k: round(v, 3) for k, v in spans.items()}))
    calls = capture_calls(lambda: render.render_frame(0, conds))
    sites = name_sites(calls, grid_names(render.model), path)
    prof = profile_frame(render, out_dir, steady, path, conds)
    print(f"{path}: frame device time {fmt_ms(prof['device_busy_ms'], ' ms')} of "
          f"{prof['steady_ms']:.3f} ms wall (idle share {fmt_ms(prof['idle_share'])})")
    record = {"audio_seconds": AUDIO_SECONDS, "hubert_frames": n_hubert, "landmark_frames":
              len(lm3d), "landmark_frames_per_audio_second": fps,
              "stage_a_wall_ms": (t2 - t1) * 1e3, "ms_per_frame": (t3 - t2) / RENDER_FRAMES * 1e3,
              "steady_ms": times, "stages_ms": stages, "lle_percent": LLE_PERCENT,
              "lle_database_rows_on_path": len(render.dataset.conds),
              "card_vs_cpu_max_abs": errs, "tf32_card_vs_cpu_relative": tf32,
              "frame_vs_cpu_max_abs": float(diff.max()),
              "stage_a_profile": {"wall_ms": wall_a, "device_busy_ms": busy,
                                  "idle_share": idle_a, "spans_ms": spans,
                                  "top_kernels": [[k[0][:100], k[1], k[2]] for k in kernels[:12]]},
              "frame_profile": prof}
    return record, launches, sites


#: the audio_train path: a synthetic LRS3 store at LRS3's clip lengths
#: (1.6–6 s at 25 fps), stage A's three networks trained in their order,
#: steps per run, mined clips per step (the shipped configs' 64), and the
#: clips of each task's card-vs-CPU step
LRS3_TRAIN_CLIPS = 320
LRS3_VAL_CLIPS = 16
LRS3_FRAMES = (40, 150)
AUDIO_TRAIN_STEPS = {"syncnet": 8, "vae": 8, "postnet": 8, "pitch_vae": 4, "pitch_postnet": 4}
AUDIO_CHECK_CLIPS = 16
AUDIO_TRAIN_YAML = {
    "syncnet": "egs/datasets/lrs3/lm3d_syncnet.yaml",
    "vae": "egs/datasets/lrs3/lm3d_vae_sync.yaml",
    "pitch_vae": "egs/datasets/lrs3/lm3d_vae_sync_pitch.yaml",
    "postnet": "egs/datasets/videos/May/lm3d_postnet_sync.yaml",
    "pitch_postnet": "egs/datasets/videos/May/lm3d_postnet_sync_pitch.yaml",
}


def write_lrs3_store(out_dir: str, n_train: int, n_val: int, seed: int = 0) -> str:
    """A binarized LRS3 store in the schema of the reference binarizer
    (``hubert [2T, 1024]``, ``mel [2T, 80]``, ``f0 [2T]``, ``idexp_lm3d [T,
    68, 3]``), written with the port's builder, T uniform in
    ``LRS3_FRAMES``: landmarks follow a low-frequency drive of the audio
    features, so there is audio-to-motion structure to learn."""
    import numpy as np

    from geneface_tpu_torch.utils.indexed_dataset import IndexedDatasetBuilder

    rng = np.random.RandomState(seed)
    os.makedirs(out_dir, exist_ok=True)
    for prefix, n in (("train", n_train), ("val", n_val)):
        b = IndexedDatasetBuilder(os.path.join(out_dir, prefix), header_size=1 << 20)
        for i in range(n):
            T = rng.randint(LRS3_FRAMES[0], LRS3_FRAMES[1] + 1)
            phase = rng.rand() * 6.28
            drive = np.sin(0.3 * np.arange(2 * T) + phase)[:, None].astype(np.float32)
            hubert = drive * rng.randn(1, 1024).astype(np.float32) * 0.5 + rng.randn(
                2 * T, 1024).astype(np.float32) * 0.1
            mel = drive * rng.randn(1, 80).astype(np.float32) + rng.randn(
                2 * T, 80).astype(np.float32) * 0.1
            lm = (drive[::2, :, None] * rng.randn(1, 68, 3) * 0.3
                  + rng.randn(T, 68, 3) * 0.02).astype(np.float32)
            b.add_item({"hubert": hubert, "mel": mel, "f0": 200 + 50 * drive[:, 0],
                        "idexp_lm3d": lm, "item_id": f"{prefix}_{i}"}, id=i)
        b.finalize()
    return out_dir


class CardDecisions:
    """The ReLU and leaky-ReLU decisions of SyncNet, the post-net and its
    discriminator (or of the given modules), taken on the card and replayed
    on the CPU: the same pre-activation can round to either side of zero on
    the two devices (~1e6 of them per step in the frozen SyncNet's 26 ReLU
    layers), and a unit that turns the other way moves the gradients below
    it by up to a percent (seen in the CPU tests against JAX). Inside
    :meth:`record` the modules' ``F.relu``/``F.leaky_relu`` run as they are
    and note which elements pass, and ``F.max_pool2d`` notes the element
    each window picks; inside :meth:`replay` the CPU run passes exactly
    those elements and picks those (the CPU's own values, its own gradient
    through them) and counts the elements whose own decision differed."""

    def __init__(self, modules: tuple | None = None):
        """``modules``: those whose ``F`` is patched (default SyncNet's and
        the post-net's)."""
        self.masks, self.flips, self.elements = [], 0, 0
        self.modules = modules

    def _patched(self, record: bool):
        import contextlib

        import torch
        import torch.nn.functional as F

        from geneface_tpu_torch.models.postnet import models as postnet_models
        from geneface_tpu_torch.models.syncnet import models as syncnet_models

        owner = self
        calls = iter(range(10**9))

        def decide(x, slope):
            if record:
                owner.masks.append((x > 0).detach())
                return F.relu(x) if slope == 0.0 else F.leaky_relu(x, slope)
            card = owner.masks[next(calls)].to(x.device)
            if card.shape != x.shape:
                raise AssertionError(f"activation {card.shape} on the card, {x.shape} on CPU")
            owner.flips += int((card != (x > 0)).sum())
            owner.elements += x.numel()
            return torch.where(card, x, slope * x)

        def pick(x, *args, **kw):
            y, idx = F.max_pool2d(x, *args, return_indices=True, **kw)
            if record:
                owner.masks.append(idx.detach())
                return y
            card = owner.masks[next(calls)].to(x.device)
            if card.shape != idx.shape:
                raise AssertionError(f"max-pool {card.shape} on the card, {idx.shape} on CPU")
            owner.flips += int((card != idx).sum())
            owner.elements += idx.numel()
            return x.flatten(2).gather(2, card.flatten(2)).view_as(y)

        class Functional:
            def __getattr__(self, name):
                return getattr(F, name)

            def relu(self, x):
                return decide(x, 0.0)

            def leaky_relu(self, x, negative_slope=0.01):
                return decide(x, negative_slope)

            def max_pool2d(self, x, *args, **kw):
                return pick(x, *args, **kw)

        @contextlib.contextmanager
        def patch():
            mods = owner.modules or (syncnet_models, postnet_models)
            for m in mods:
                m.F = Functional()
            try:
                yield self
            finally:
                for m in mods:
                    m.F = F

        return patch()

    def record(self):
        self.masks = []
        return self._patched(True)

    def replay(self):
        self.flips = self.elements = 0
        return self._patched(False)


def audio_task_cfg(name: str, store: str, work: str, **over):
    """The shipped config of one stage-A task on the store, ``max_updates``
    its ``AUDIO_TRAIN_STEPS``, a validation (one val batch) at the end."""
    from geneface_tpu_torch.config.config import load_config

    steps = AUDIO_TRAIN_STEPS[name]
    return load_config(os.path.join(REPO, AUDIO_TRAIN_YAML[name]), overrides=dict(
        data_dir=store, lrs3_data_dir=store, work_dir=os.path.join(work, name),
        max_updates=steps, val_check_interval=steps, tb_log_interval=steps,
        num_sanity_val_steps=0, eval_max_batches=1, **over))


def trees_differ(a: dict, b: dict, key: str = "") -> list:
    """Paths where two nested dicts of arrays differ (in keys or values)."""
    import numpy as np

    if sorted(a) != sorted(b):
        return [key + "/<keys>"]
    out = []
    for k in b:
        if isinstance(b[k], dict):
            out += trees_differ(a[k], b[k], f"{key}/{k}")
        elif not np.array_equal(np.asarray(a[k]), np.asarray(b[k])):
            out.append(f"{key}/{k}")
    return out


def cut_batch(batch: dict, n: int) -> dict:
    return {k: v[:n] for k, v in batch.items()}


def audio_step_vs_cpu(name: str, task, lrs3: dict, person: dict) -> dict:
    """One step of ``task`` (trained on the card) on ``AUDIO_CHECK_CLIPS``
    clips, the same mined indices and noise, on the card and on the port's
    plain CPU path (a CPU task of the same config with the card task's
    parameters, the card's activation decisions): loss within 1e-5
    relative, every parameter's gradient within 1e-4 relative L2, every
    loss finite, each optimizer's gradient non-zero. SyncNet: its loss on
    the clips; the VAE: with the sync term on; the post-net: the generator
    step with ``adv`` and ``sync`` on, then the discriminator on the
    generator's refinement."""
    import numpy as np
    import torch

    from geneface_tpu_torch.tasks.syncnet import mine_sync_clips, to_device

    lrs3 = cut_batch(lrs3, AUDIO_CHECK_CLIPS)
    person = cut_batch(person, AUDIO_CHECK_CLIPS)
    idx = mine_sync_clips(lrs3["y_mask"].sum(-1).astype(int), task.clip_batch,
                          np.random.RandomState(3), infer=not name == "syncnet")
    gen = torch.Generator().manual_seed(11)
    B, T = lrs3["y_mask"].shape
    Bp, Tp = person["y_mask"].shape
    if name != "syncnet":
        frozen = task.vae if "postnet" in name else task.model
        noises = (torch.randn(frozen.noise_shape(B, T), generator=gen),
                  torch.randn(frozen.noise_shape(Bp, Tp), generator=gen))
    decisions = CardDecisions()
    out = {}
    for dev in ("cuda", "cpu"):
        t = task if dev == "cuda" else type(task)(task.cfg, device="cpu")
        if dev == "cpu":
            t.build()
            t.restore_state(task.checkpoint_payload(0)["state"])
            for mod in ("syncnet", "vae"):
                if hasattr(task, mod):
                    getattr(t, mod).load_state_dict(getattr(task, mod).state_dict())
            if hasattr(task, "enable_sync"):
                t.enable_sync = True
        nets = [t.model] + ([t.disc] if hasattr(t, "disc") else [])
        for m in nets:
            m.zero_grad(set_to_none=True)
        with decisions.record() if dev == "cuda" else decisions.replay():
            if name == "syncnet":
                from geneface_tpu_torch.tasks.syncnet import gather_clips

                d = to_device(lrs3, ("mouth_lm3d", "hubert"), t.device)
                mouth, mel = gather_clips(d["mouth_lm3d"], d["hubert"], *idx[:4])
                loss, losses = t.loss_fn({"mouth": mouth, "mel": mel,
                                          "labels": torch.from_numpy(idx[4]).to(t.device)})
                loss.backward()
            elif "vae" in name:
                d = to_device(lrs3, ("hubert", "y", "y_mask", "f0"), t.device)
                loss, losses = t.loss_fn(d, idx[:4], noises[0].to(t.device),
                                         float(t.cfg.get("lambda_sync", 0.01)))
                loss.backward()
            else:
                keys = t.keys()
                dl, dp = to_device(lrs3, keys, t.device), to_device(person, keys, t.device)
                loss, losses, pred = t.gen_loss(dl, dp, idx[:4], tuple(
                    n.to(t.device) for n in noises), 1.0)
                loss.backward()
                d_loss, d_losses = t.disc_loss(pred, dp["y"], dp["y_mask"])
                d_loss.backward()
                losses = {**losses, **d_losses}
        out[dev] = ({k: float(v.detach()) for k, v in losses.items()},
                    {f"{i}.{n}": p.grad.detach().cpu().double() for i, m in enumerate(nets)
                     for n, p in m.named_parameters() if p.grad is not None},
                    [sum(int(p.grad is not None and bool((p.grad != 0).any()))
                         for p in m.parameters()) for m in nets])
    (lg, gg, nz), (lc, gc, _) = out["cuda"], out["cpu"]
    if gg.keys() != gc.keys() or not gc:
        raise AssertionError(f"audio_train.{name}: gradients of {len(gg)} tensors on the card, "
                             f"{len(gc)} on CPU")
    if not all(np.isfinite(v) for v in list(lg.values()) + list(lc.values())):
        raise AssertionError(f"audio_train.{name}: non-finite loss {lg} / {lc}")
    loss_err = {k: abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-30) for k in lc}
    errs = {n: float((gg[n] - g).norm() / g.norm()) if g.norm() > 0 else float(gg[n].norm())
            for n, g in gc.items()}
    res = {"clips": AUDIO_CHECK_CLIPS, "mined": len(idx[0]), "loss_cuda": lg, "loss_cpu": lc,
           "worst_loss_rel": max(loss_err.values()), "worst_grad_rel_l2": max(errs.values()),
           "worst_grad": max(errs, key=errs.get), "n_params_with_grad": len(gc),
           "nonzero_grad_params_by_optimizer": nz,
           "activation_flips": decisions.flips, "activation_elements": decisions.elements}
    if not res["worst_loss_rel"] <= 1e-5 or not res["worst_grad_rel_l2"] <= 1e-4 or not all(nz):
        raise AssertionError(f"audio_train.{name}: card vs CPU: {res}; all: {errs}")
    print(f"audio_train.{name}: card vs CPU plain path on one step passed: " + json.dumps(res))
    return res


def audio_train_phase(cfg, out_dir: str, path: str = "audio_train") -> tuple:
    """Stage A's training on the card through ``Trainer.fit`` on the shipped
    configs: SyncNet, the VAE on that SyncNet run, the post-net on both,
    then the pitch VAE and the pitch post-net; each task's step held
    against the CPU plain path, timed and profiled; the frozen upstreams
    bit-identical after their dependants train; then ``PostnetInfer`` of
    ``audio_serve``'s 8 s wav from the trained VAE and post-net →
    (record, launches, sites)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity

    from geneface_tpu_torch.convert import flax_variables
    from geneface_tpu_torch.data.lrs3_dataset import LRS3SeqDataset
    from geneface_tpu_torch.inference import PostnetInfer
    from geneface_tpu_torch.kernels import LAUNCHES
    from geneface_tpu_torch.tasks.run import resolve_task
    from geneface_tpu_torch.training.trainer import Trainer
    from geneface_tpu_torch.utils.audio import extract_f0, extract_hubert, load_hubert, load_wav16k
    from geneface_tpu_torch.utils.checkpoint import get_last_checkpoint, load_checkpoint

    root = os.path.dirname(cfg["work_dir"])
    work = os.path.join(root, "audio_train")
    t0 = time.perf_counter()
    store = write_lrs3_store(os.path.join(root, "lrs3"), LRS3_TRAIN_CLIPS, LRS3_VAL_CLIPS)
    n_bytes = sum(os.path.getsize(os.path.join(store, f)) for f in os.listdir(store))
    ds = LRS3SeqDataset("train", store, max_tokens=60000)
    host = []
    batches = ds.iter_batches(seed=0)
    for _ in range(3):
        ts = time.perf_counter()
        b = next(batches)
        host.append(((time.perf_counter() - ts) * 1e3, len(b["item_names"]), b["y"].shape[1]))
    print(f"{path}: LRS3 store of {LRS3_TRAIN_CLIPS} + {LRS3_VAL_CLIPS} clips, T in "
          f"{LRS3_FRAMES}, {n_bytes / 2**20:.1f} MiB written in {time.perf_counter() - t0:.1f} s; "
          f"{len(ds.batches)} train batches at max_tokens 60000 of "
          f"{[len(x) for x in ds.batches]} clips; host data ms per batch (read + collate; "
          f"clips, padded frames) " + json.dumps([[round(h[0], 3), h[1], h[2]] for h in host]))

    runs = {}
    plan = [("syncnet", {}),
            ("vae", {"syncnet_work_dir": os.path.join(work, "syncnet")}),
            ("postnet", {"syncnet_work_dir": os.path.join(work, "syncnet"),
                         "audio2motion_work_dir": os.path.join(work, "vae")}),
            ("pitch_vae", {"syncnet_work_dir": os.path.join(work, "syncnet")}),
            ("pitch_postnet", {"syncnet_work_dir": os.path.join(work, "syncnet"),
                               "audio2motion_work_dir": os.path.join(work, "pitch_vae")})]
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    want = {"gather_rows": 0, "scatter_add_rows": 0}
    tasks = {}
    for name, over in plan:
        tcfg = audio_task_cfg(name, store, work, **over)
        task = resolve_task(tcfg["task_cls"])(tcfg)  # cuda
        step_ms = []
        real_step = task.train_step

        def timed(batch, real_step=real_step, step_ms=step_ms):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            m = real_step(batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - ts) * 1e3)
            return m

        task.train_step = timed
        frozen = {}
        real_build = task.build

        def build(task=task, real_build=real_build, frozen=frozen):
            real_build()
            for mod in ("syncnet", "vae"):
                if hasattr(task, mod):
                    frozen[mod] = {n: p.detach().clone()
                                   for n, p in getattr(task, mod).named_parameters()}

        task.build = build
        t1 = time.perf_counter()
        if Trainer(task).fit() != AUDIO_TRAIN_STEPS[name]:
            raise AssertionError(f"{path}.{name}: the run did not reach its last step")
        fit_s = time.perf_counter() - t1
        task.train_step = real_step
        steps = AUDIO_TRAIN_STEPS[name]
        # launches: two clip gathers per step (and per validation of
        # SyncNet and the VAE: the post-net's validation gathers none), one
        # scatter-add per step of the tasks that train through the clips
        val = 0 if "postnet" in name else 1
        want["gather_rows"] += 2 * (steps + val)
        want["scatter_add_rows"] += 0 if name == "syncnet" else steps
        # the frozen upstreams: unmoved, and equal to their runs' checkpoints
        upstream = {"syncnet": over.get("syncnet_work_dir"),
                    "vae": over.get("audio2motion_work_dir")}
        for mod, ps in frozen.items():
            net = getattr(task, mod)
            moved = [n for n, p in net.named_parameters() if not torch.equal(p, ps[n])]
            ref = load_checkpoint(get_last_checkpoint(upstream[mod]))["state"]["params"]
            differ = trees_differ(flax_variables(net), ref)
            if moved or differ:
                raise AssertionError(f"{path}.{name}: frozen {mod} moved {moved[:5]}, differs "
                                     f"from its checkpoint in {differ[:5]}")
        rows = [json.loads(x) for x in open(os.path.join(tcfg["work_dir"], "metrics.jsonl"))]
        losses = {k: v for r in rows for k, v in r.items()
                  if k.startswith(("tr/", "val/")) and k != "tr/steps_per_sec"}
        if not losses or not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"{path}.{name}: losses {losses}")
        median = sorted(step_ms[2:])[len(step_ms[2:]) // 2]
        runs[name] = {"fit_s": fit_s, "step_ms": step_ms, "median_step_ms": median,
                      "frozen_checked": sorted(frozen), "metrics": losses}
        tasks[name] = task
        print(f"{path}.{name}: {steps} steps through Trainer.fit in {fit_s:.3f} s; median "
              f"ms/step {median:.3f} (first two left out), steps "
              + json.dumps([round(x, 3) for x in step_ms]) + "; logged "
              + json.dumps({k: round(v, 5) for k, v in losses.items()}))
    launches = dict(LAUNCHES)
    if launches != want or not all(launches.values()):
        raise AssertionError(f"{path} launches {launches}, expected {want}")

    sites, checks, profiles = {}, {}, {}
    for name, task in tasks.items():
        it = task.train_batches(0)
        lrs3, person = next(it), next(it)
        checks[name] = audio_step_vs_cpu(name, task, lrs3, person)
        batch = next(it)
        task.train_step(batch)  # warm
        wall = runs[name]["median_step_ms"]
        kernels, spans, busy = kernel_table(profiled(
            lambda: task.train_step(batch), [ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        with open(os.path.join(out_dir, f"{path}_{name}_step_profile.txt"), "w") as f:
            f.write(f"{name} step wall (median) {wall:.3f} ms, device busy "
                    f"{fmt_ms(busy, ' ms')}\n")
            for sname, ms in sorted(spans.items(), key=lambda s: -s[1]):
                f.write(f"stage {sname:24s} {ms:9.3f} ms\n")
            for kname, ms, n in kernels:
                f.write(f"{ms:9.3f} ms {n:5d}x {kname}\n")
        idle = None if busy is None else max(0.0, 1.0 - busy / wall)
        profiles[name] = {"wall_ms": wall, "device_busy_ms": busy, "idle_share": idle,
                          "spans_ms": spans,
                          "top_kernels": [[k[0][:100], k[1], k[2]] for k in kernels[:12]]}
        print(f"{path}.{name}: step device time {fmt_ms(busy, ' ms')} of {wall:.3f} ms wall "
              f"(idle share {fmt_ms(idle)}); spans ms "
              + json.dumps({k: round(v, 3) for k, v in spans.items()}))
        sites.update(name_sites(capture_calls(lambda: task.train_step(next(it))), {},
                                f"{path}.{name}"))

    # stage A from the trained VAE and post-net on audio_serve's wav
    audio = os.path.join(root, "audio")
    files = {"wav": os.path.join(audio, "speech.wav"), "hubert": os.path.join(audio, "hubert.pkl")}
    if not all(os.path.exists(f) for f in files.values()):
        files = write_audio_models(audio)
    os.environ["GF_HUBERT_CKPT"] = files["hubert"]
    pcfg = audio_task_cfg("postnet", store, work, audio2motion_work_dir=os.path.join(
        work, "vae"), postnet_work_dir=os.path.join(work, "postnet"))
    npy = os.path.join(work, "pred_lm3d.npy")
    t1 = time.perf_counter()
    lm3d = PostnetInfer(pcfg).infer(wav_path=files["wav"], out_npy=npy, seed=0)
    infer_s = time.perf_counter() - t1
    wav = load_wav16k(files["wav"])
    n_rows = (min(2 * ((len(wav) - 400) // 320 + 1), 1 + len(wav) // 160) // 16) * 16
    if lm3d.shape != (n_rows // 2, 68, 3) or not np.isfinite(lm3d).all():
        raise AssertionError(f"{path}: PostnetInfer gave {lm3d.shape}")
    card = PostnetInfer(pcfg)
    cpu = PostnetInfer(pcfg, device="cpu")
    hubert = extract_hubert(wav, model=load_hubert(files["hubert"], "cuda"))[:n_rows]
    f0 = extract_f0(wav)[:n_rows]
    from geneface_tpu_torch.inference.audio2motion_infer import prior_noise

    noise = prior_noise(card.vae, n_rows // 2, 0)
    got = card.refine(card.sample(hubert, f0, noise), f0)
    ref = cpu.refine(cpu.sample(hubert, f0, noise), f0)
    err = float(np.abs(got - ref).max())
    if not err <= 1e-5 * float(np.abs(ref).max()):
        raise AssertionError(f"{path}: trained stage A card vs CPU {err}")
    print(f"{path}: PostnetInfer of the {AUDIO_SECONDS} s wav from the trained VAE and "
          f"post-net: lm3d {lm3d.shape} in {infer_s:.3f} s (HuBERT read included); card vs "
          f"CPU max abs {err:.3e} (bound 1e-5 of max |ref| {float(np.abs(ref).max()):.3e})")
    record = {"store_mib": n_bytes / 2**20, "train_batches": [len(x) for x in ds.batches],
              "host_data_ms": host, "runs": runs, "card_vs_cpu": checks,
              "step_profiles": profiles, "infer_s": infer_s,
              "infer_card_vs_cpu_max_abs": err, "lm3d_shape": list(lm3d.shape)}
    return record, launches, sites


def train_cfg(cfg: dict) -> dict:
    """A training cell: the full-width config at ``base.yaml``'s training
    keys, 65,536 rays per step, the occupancy sweep every 16 steps."""
    return dict(
        cfg, n_rays=TRAIN_RAYS, finetune_lips=False, update_extra_interval=16,
        lattice_K=32, lr=0.0005, scheduler="exponential", lambda_ambient=0.1,
        lambda_weights_entropy=1e-4, native_loader=False,
    )


def check_grads_vs_cpu(task, batch, path: str = "train", lip: bool = False) -> dict:
    """One step's loss and gradients on the card against the port's plain
    CPU path, on the trained task's parameters and occupancy, one batch (cut
    to ``CHECK_RAYS`` rays) and the same noises, with float32 MLPs on both
    sides (at bf16 a hidden unit may round the other way on one side).
    Tolerances: loss rel 1e-3; per parameter, the relative L2 error of the
    gradient <= 0.1. Sums run in another order (cuBLAS, atomics), so the
    ambient coordinates differ in their last bits, and one that sits on a
    block boundary of the fused ambient grid can take another row, where
    the feature jumps (the fused layout's aliasing). Over twelve runs on the
    card, with each side's own rays, that moved the loss by up to 2.4e-5
    (relative) and a gradient by up to 2.3e-2 (relative L2, the position
    hash table); a fault such as a missing gradient gives 1. The torso
    task's frozen head has no gradient on either side. ``lip``: the batch
    is a lip patch (its ``CHECK_RAYS`` pixels), trained with the LPIPS term
    on both sides.

    Both sides rebuild the batch's rays from its pixel indices, and the
    card's matmul and norm round some directions differently in the last
    bit; a sample on a grid cell's edge then reads the next cell, which on
    the dense 64² lip patch moved the position grid's gradient by 1.3e-2
    and a cancelling sum (the attention conv's bias, one scalar) by 0.41
    (relative L2, on an H100 80GB HBM3 at 700 W). So the CPU side takes
    the card's rays, held to its own first: max abs error <= 1e-6.

    The torso grid is looked up at ``x + Δxy``, with ``Δxy`` from the
    torso's deform net, which card and CPU round differently in its last
    bits; the grid's spatial slope, through which the deform net learns,
    jumps at every cell and fused-block edge: a last-bit change of ``Δxy``
    moves the torso grid's and deform net's gradients by percents (relative
    L2), at times past the 0.1 bound. So the CPU side looks the torso grid
    up at the card's ``Δxy`` (its values from the card, the gradient
    through the CPU's own deform net), and ``Δxy`` itself is held card vs
    CPU: max abs error <= 1e-4 of its largest magnitude.

    The ambient grid is looked up at the ambient MLP's output, which card
    and CPU round apart in the last bit as well, and the fused layout's
    grouped levels jump at block edges: with each side's own ambient
    coordinates a lip step's attention-conv bias read 0.20 (relative L2,
    a cancelling sum of one scalar) and the position grid's hash group
    2.8e-2 in one call on an H100 80GB HBM3 at 700 W, where earlier calls
    read 4e-5. So the CPU side looks the ambient grid up at the card's
    ambient logits in the same way (the card's values, the gradient through
    the CPU's own ambient MLP), and the logits are held card vs CPU: max
    abs error <= 1e-4 of their largest magnitude.

    The MLPs' ReLU and the attention net's leaky-ReLU decisions, and the
    LPIPS tower's ReLU and max-pool choices, are the card's on the CPU side
    too (:class:`CardDecisions`): a pre-activation that rounds to the other
    side of zero, or a max-pool window whose two largest elements round
    apart, sends the gradient another way. One max-pool choice of the lip
    step's LPIPS moved the gradient reaching the rendered patch by
    percents, and with it every gradient of the step: a lip step read 0.566
    at the attention conv's bias, 0.19 at its weights and 2.3e-2 at the
    position grid's hash group in one call on an H100 80GB HBM3 at 700 W,
    where others read 1e-5. When the CPU's own decisions differ from the
    card's somewhere, the step runs once more on the CPU with its own, and
    that run's worst gradient is printed beside the held one (reported,
    not held)."""
    import contextlib

    import torch

    from geneface_tpu_torch.models import lpips
    from geneface_tpu_torch.models.radnerf import OccupancyState, cond_encoder

    cut = {k: (v[:CHECK_RAYS] if k in ("inds", "gt_img_u8", "bg_img_u8", "bg_torso_img_u8")
               else v) for k, v in batch.items()}
    noises = torch.rand(CHECK_RAYS, generator=torch.Generator().manual_seed(5))
    params = {k: v.detach().cpu() for k, v in task.model.state_dict().items()}
    occ = [x.cpu() for x in task.occ]
    deform = {}

    def same_deform(side):
        def hook(module, inputs, dxy):
            deform[side] = dxy.detach().cpu()
            if side != "cuda":  # the card's values, plus an exact zero that carries the gradient
                return deform["cuda"] + (dxy - dxy.detach())
            return None

        return hook

    ambient = {"cuda": [], "cpu": [], "cpu_own": []}

    def same_ambient(side):
        def hook(module, inputs, logits):
            ambient[side].append([x.detach().cpu() for x in logits])
            if side != "cuda":  # the card's values of the same call, the CPU's gradient
                card = ambient["cuda"][len(ambient[side]) - 1]
                return tuple(c + (x - x.detach()) for c, x in zip(card, logits))
            return None

        return hook

    decisions = CardDecisions((cond_encoder, lpips))
    out = {}
    for side in ("cuda", "cpu", "cpu_own"):
        if side == "cpu_own" and not decisions.flips:
            break
        dev = "cuda" if side == "cuda" else "cpu"
        t = type(task)(task.cfg, device=dev, dtype=torch.float32)
        t.build()
        t.model.load_state_dict(params)
        t.model.ambient_net.register_forward_hook(same_ambient(side))
        t.set_occupancy(OccupancyState(*[x.to(t.device) for x in occ]))
        if hasattr(task, "torso_occ"):
            t.torso_occ = type(task.torso_occ)(*[x.to(t.device) for x in task.torso_occ])
            t.model.torso_deform_net.register_forward_hook(same_deform(side))
        else:
            t._spr_bucket, t._latk_bucket = task._spr_bucket, task._latk_bucket
        dbatch = t.device_batch(cut, task._step)
        if side == "cuda":
            rays = {k: dbatch[k].detach().cpu() for k in ("rays_o", "rays_d")}
        else:  # the card's rays, held to the CPU's first
            ray_err = max(float((dbatch[k] - v).abs().max()) for k, v in rays.items())
            dbatch.update(rays)
        with {"cuda": decisions.record, "cpu": decisions.replay}.get(
                side, contextlib.nullcontext)():
            loss, losses = t.loss_fn(dbatch, noises.to(t.device), train=True,
                                     **({"lip": True} if lip else {}))
            loss.backward()
        out[side] = (float(loss.detach()), float(losses["mean_samples"]),
                    {n: p.grad.detach().cpu().double() for n, p in t.model.named_parameters()
                     if p.grad is not None})
    (lg, sg, gg), (lc, sc_, gc) = out["cuda"], out["cpu"]
    if gg.keys() != gc.keys() or not gc:
        raise AssertionError(f"{path}: gradients of {sorted(gg)} on the card, {sorted(gc)} on CPU")

    def rel_errs(grads):
        return {n: float((gg[n] - g).norm() / g.norm()) if g.norm() > 0
                else float(gg[n].norm()) for n, g in grads.items()}

    errs = rel_errs(gc)
    own = rel_errs(out["cpu_own"][2]) if "cpu_own" in out else {}
    bad = {n: e for n, e in errs.items() if not e <= 0.1}
    if bad:
        raise AssertionError(f"{path}: relative L2 error of gradients card vs CPU {bad}; "
                             f"all: {errs}; decisions that differed on the CPU: "
                             f"{decisions.flips} of {decisions.elements}")
    # the march rounds its positions as on the CPU: the same samples
    if abs(lg - lc) > 1e-3 * abs(lc) or sg != sc_:
        raise AssertionError(f"{path}: loss {lg} vs {lc} / mean samples {sg} vs {sc_}")
    if not ray_err <= 1e-6:
        raise AssertionError(f"{path}: rays card vs CPU differ by {ray_err}")
    res = {"rays": CHECK_RAYS, "mlp_dtype": "float32", "loss_cuda": lg, "loss_cpu": lc,
           "mean_samples": sg, "worst_grad_rel_l2": max(errs.values()),
           "worst_grad": max(errs, key=errs.get), "rays_max_abs_err": ray_err,
           "n_params_with_grad": len(gc), "decisions_replayed": decisions.elements,
           "decisions_differing_on_cpu": decisions.flips,
           "worst_grad_rel_l2_own_decisions": max(own.values()) if own else None,
           "worst_grad_own_decisions": max(own, key=own.get) if own else None}
    if len(ambient["cpu"]) != len(ambient["cuda"]) or not ambient["cpu"]:
        raise AssertionError(f"{path}: ambient MLP calls {len(ambient['cuda'])} on the card, "
                             f"{len(ambient['cpu'])} on the CPU")
    pairs = [(g, c) for gs, cs in zip(ambient["cuda"], ambient["cpu"]) for g, c in zip(gs, cs)]
    res["ambient_max_abs_err"] = max(float((g - c).abs().max()) for g, c in pairs)
    res["ambient_max_abs"] = max(float(c.abs().max()) for _, c in pairs)
    if not res["ambient_max_abs_err"] <= 1e-4 * res["ambient_max_abs"]:
        raise AssertionError(f"{path}: ambient logits card vs CPU: {res}")
    if deform:
        scale = float(deform["cpu"].abs().max())
        res["deform_max_abs_err"] = float((deform["cuda"] - deform["cpu"]).abs().max())
        res["deform_max_abs"] = scale
        if not res["deform_max_abs_err"] <= 1e-4 * scale:
            raise AssertionError(f"{path}: torso deform card vs CPU: {res}")
    print(f"{path}: card vs CPU plain path on one step passed: " + json.dumps(res))
    return res


def train_phase(cfg, out_dir: str, path: str = "train") -> tuple:
    """A training path: ``RADNeRFTask.train_step`` (or, with ``cfg`` from
    :func:`torso_cfg`, ``RADNeRFTorsoTask.train_step``) for ``TRAIN_STEPS``
    steps (sweeps at steps 0 and 16); → (record, launches, sites)."""
    import numpy as np
    import torch

    from geneface_tpu_torch.kernels import LAUNCHES
    from geneface_tpu_torch.tasks.radnerf import RADNeRFTask
    from geneface_tpu_torch.tasks.radnerf_torso import RADNeRFTorsoTask
    from geneface_tpu_torch.training.optim import (
        param_groups,
        radnerf_label_fn,
        torso_label_fn,
    )

    torso = path.startswith("torso")
    task = (RADNeRFTorsoTask if torso else RADNeRFTask)(train_cfg(cfg))  # cuda, bf16 MLPs
    task.build()
    head = {n: p.detach().clone() for n, p in task.model.named_parameters()
            if not p.requires_grad}
    batches = task.train_batches()
    interval = int(task.cfg["update_extra_interval"])
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    step_ms, losses, spr = [], [], []
    t_all = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        batch = next(batches)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = task.train_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3)
        losses.append(float(out["total_loss"]))
        spr.append(float(out["mean_samples"]))
    wall = time.perf_counter() - t_all
    launches = dict(LAUNCHES)
    n_head, n_torso = n_grid_groups(task.model)
    n_sweeps = len(range(0, TRAIN_STEPS, interval))
    if torso:
        # per step: the head's grid gathers at the slab and the torso's (K8),
        # the torso grid's backward scatters (K1); per torso sweep one
        # gather per torso group
        sweep_chunks = 1
        want = {
            "gather_rows": TRAIN_STEPS * (n_head + n_torso) + n_sweeps * n_torso,
            "scatter_add_rows": TRAIN_STEPS * n_torso,
        }
    else:
        # per step: the grid gathers and the composite's backward gather
        # (K8), the composite sums and the grid backward scatters (K1); per
        # sweep one gather per group and chunk
        sweep_chunks = 16
        want = {
            "gather_rows": TRAIN_STEPS * (n_head + 1) + n_sweeps * sweep_chunks * n_head,
            "scatter_add_rows": TRAIN_STEPS * (1 + n_head),
        }
    if launches != want:
        raise AssertionError(f"{path} launches {launches}, expected {want}")
    print(f"{path}: losses " + json.dumps([round(x, 6) for x in losses]))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{path}: non-finite training loss")
    groups_nonzero = {}
    label_fn, mults = ((torso_label_fn, {"net": 1, "grid": 1, "frozen": 0}) if torso
                       else (radnerf_label_fn, {"net": 1, "grid": 1, "att": 1}))
    for g in param_groups(task.model, label_fn, mults):
        if g["name"] == "frozen":  # the torso task's head: checked below
            continue
        groups_nonzero[g["name"]] = sum(
            int(p.grad is not None and bool((p.grad != 0).any())) for p in g["params"]
        )
        if not groups_nonzero[g["name"]]:
            raise AssertionError(f"{path}: parameter group {g['name']} has a zero gradient "
                                 "on the card")
    print(f"{path}: parameters with a non-zero gradient on the card, by group: "
          f"{groups_nonzero}")
    if torso:
        moved = [n for n, p in task.model.named_parameters()
                 if n in head and not torch.equal(p, head[n])]
        if moved or not head:
            raise AssertionError(f"{path}: frozen head parameters moved: {moved}")
        print(f"{path}: all {len(head)} head parameters bit-identical after "
              f"{TRAIN_STEPS} steps")
    sweep_steps = [i for i in range(TRAIN_STEPS) if i % interval == 0]
    plain = [t for i, t in enumerate(step_ms) if i % interval and i > 1]
    median = sorted(plain)[len(plain) // 2]
    n_rays = int(task.cfg["n_rays"])
    print(f"{path}: median ms/step {median:.3f} (steps without a sweep, first two left "
          f"out); sweep steps {[round(step_ms[i], 3) for i in sweep_steps]} ms; "
          f"{n_rays / median * 1e3:.0f} rays/s; {TRAIN_STEPS} steps in {wall:.3f} s")
    record = {"step_ms": step_ms, "median_step_ms": median, "losses": losses,
              "mean_samples_per_ray": spr, "rays_per_s": n_rays / median * 1e3,
              "nonzero_grad_params": groups_nonzero}
    if torso:
        print(f"{path}: head samples per ray (walk, slab of {task.cfg['max_steps']}) per step "
              + json.dumps([round(x, 3) for x in spr]))
    else:
        mspr = task.render_kwargs()["mean_samples_per_ray"]
        Mc = min(int(-(-n_rays * mspr // 1024) * 1024), n_rays * int(task.cfg["max_steps"]))
        record["sample_capacity"] = Mc
        print(f"{path}: sample capacity Mc={Mc} (mean_samples_per_ray bucket {mspr}, "
              f"lattice_K {task.render_kwargs()['lattice_K']}); mean samples/ray per step "
              + json.dumps([round(x, 3) for x in spr]))

    prof = profile_train_step(task, next(batches), out_dir, median, path)
    print(f"{path}: step device time {fmt_ms(prof['device_busy_ms'], ' ms')} of "
          f"{prof['wall_ms']:.3f} ms wall (idle share {fmt_ms(prof['idle_share'])}, "
          f"{prof['n_device_ops']} device "
          "operations); stage spans ms "
          + json.dumps({k: round(v, 3) for k, v in prof["stages_ms"].items()}))
    sweep = sweep_ms(task)
    print(f"{path}: sweep alone {sweep:.3f} ms (CUDA events, one unprofiled sweep)")
    record.update(profile=prof, sweep_ms=sweep,
                  grad_check=check_grads_vs_cpu(task, next(batches), path))
    if path == "train":
        record["data_ms"] = data_time(task.cfg, path)

    # the kernel sites of one step without a sweep and of one sweep
    grids = grid_names(task.model)
    sweep_path = "torso_sweep" if torso else "sweep"
    sites = name_sites(capture_calls(lambda: task.train_step(next(batches))), grids, path)
    saved_step = task._step
    task._step = interval * (saved_step // interval + 1)
    sites.update(name_sites(capture_calls(task.maybe_update_occ), grids, sweep_path))
    task._step = saved_step
    record["sweep_launches_per_site"] = sweep_chunks
    return record, launches, sites


def data_time(cfg: dict, path: str = "train", n: int = 16) -> dict:
    """The dataset's batch assembly apart from the step: ``n`` training
    items of ``n_rays`` rays from the numpy path and from the native
    loader (``native_loader``), in turns, host ms each; the two must give
    the same pixel indices and pixels within one uint8 level."""
    import numpy as np

    from geneface_tpu_torch.data.radnerf_dataset import RADNeRFDataset

    dss = {k: RADNeRFDataset("train", cfg["data_dir"], dict(cfg, native_loader=k == "native"),
                             training=True) for k in ("numpy", "native")}
    if dss["native"].native_loader is None or dss["numpy"].native_loader is not None:
        raise AssertionError(f"{path}: the datasets did not take the paths asked of them")
    ms, worst = {"numpy": [], "native": []}, 0
    for i in range(n):
        items = {}
        for k in (("numpy", "native") if i % 2 == 0 else ("native", "numpy")):
            ts = time.perf_counter()
            items[k] = dss[k][i % len(dss[k])]
            ms[k].append((time.perf_counter() - ts) * 1e3)
        a, b = items["native"], items["numpy"]
        if not np.array_equal(a["inds"], b["inds"]):
            raise AssertionError(f"{path}: native and numpy batches sampled other pixels")
        for key in ("gt_img_u8", "bg_img_u8", "bg_torso_img_u8"):
            worst = max(worst, int(np.abs(a[key].astype(np.int16) - b[key]).max()))
    if worst > 1:
        raise AssertionError(f"{path}: native vs numpy pixels differ by {worst} levels")
    med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
    rays = len(items["native"]["inds"])
    print(f"{path}: host data ms per batch of {rays} rays (dataset item, apart from the "
          f"step; median of {n}, in turns): numpy {med['numpy']:.3f}, native "
          f"{med['native']:.3f}; pixels agree within {worst} uint8 level(s); the steps "
          "above ran with native_loader false")
    return {"rays": rays, "numpy_ms": med["numpy"], "native_ms": med["native"],
            "numpy_all_ms": ms["numpy"], "native_all_ms": ms["native"],
            "max_level_diff": worst}


#: the ddp path: the training cell's 6 head steps (the sweep at step 0) and
#: 2 lip steps of 64² patches, then 4 torso frames, on two gloo ranks that
#: share the card; the NCCL run is the train cell's TRAIN_STEPS
DDP_HEAD_STEPS = 6
DDP_LIP_STEPS = 2
DDP_FRAMES = 4
DDP_WORLD = 2
_DIST_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
             "GF_DIST_BACKEND")


def free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ddp_cfg(cfg: dict) -> dict:
    """The ddp steps' cell: the training cell with the lip phase from step
    ``DDP_HEAD_STEPS`` (64² patches, seeded random LPIPS) and the sweep
    every 16 steps."""
    return dict(lip_cfg(cfg), finetune_lips_start_iter=DDP_HEAD_STEPS - 1,
                update_extra_interval=16)


def ddp_batches(dcfg: dict) -> list:
    """``DDP_HEAD_STEPS`` training items of 65,536 rays, then
    ``DDP_LIP_STEPS`` lip patches, from the dataset's seeded draws."""
    from geneface_tpu_torch.data.radnerf_dataset import RADNeRFDataset

    ds = RADNeRFDataset("train", dcfg["data_dir"], dcfg, training=True)
    out = [ds[i % len(ds)] for i in range(DDP_HEAD_STEPS)]
    ds.finetune_lip_flag = True
    return out + [ds[i % len(ds)] for i in range(DDP_LIP_STEPS)]


def recorded_steps(task, batches, start_from: list | None = None) -> dict:
    """``train_step`` over ``batches``: each step's losses, host ms to a
    synchronize, the gradients the optimizer applies (float32, CPU) and the
    model's state before each step; ``start_from``: such states, loaded
    before each step (so that every step starts where the recorded run's
    did: the card's atomic order, which Adam's first updates amplify, would
    otherwise take the two runs apart after a step or two)."""
    import torch

    named = list(task.model.named_parameters())
    grads, real = [], task.optimizer.step

    def recording():
        grads.append({n: p.grad.detach().float().cpu() for n, p in named if p.grad is not None})
        real()

    task.optimizer.step = recording
    losses, ms, states = [], [], []
    try:
        for i, batch in enumerate(batches):
            if start_from is not None:
                task.model.load_state_dict(start_from[i])
            states.append({k: v.detach().cpu().clone() for k, v in task.model.state_dict().items()})
            torch.cuda.synchronize()
            ts = time.perf_counter()
            out = task.train_step(batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - ts) * 1e3)
            losses.append({k: float(v) for k, v in out.items()})
    finally:
        task.optimizer.step = real
    return {"losses": losses, "ms": ms, "grads": grads, "states": states}


def timed_sync(task, log: list) -> None:
    """Time every gradient all-reduce of ``task`` (host ms to a
    synchronize) and count its bytes into ``log``."""
    import torch

    real = task.sync_grads

    def sync(params):
        params = list(params)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        real(params)
        torch.cuda.synchronize()
        log.append(((time.perf_counter() - ts) * 1e3,
                    sum(p.grad.numel() * p.grad.element_size() for p in params
                        if p.grad is not None)))

    task.sync_grads = sync


def grad_errors(got: dict, ref: dict) -> dict:
    """Relative L2 error of each gradient against ``ref``."""
    if got.keys() != ref.keys():
        raise AssertionError(f"gradients of {sorted(got)} against {sorted(ref)}")
    return {n: float((got[n].double() - g.double()).norm() / g.double().norm())
            if float(g.norm()) > 0 else float(got[n].norm()) for n, g in ref.items()}


def ddp_fit(cfg: dict, work: str, nccl: bool, start_from: list | None = None) -> dict:
    """``Trainer.fit`` of the training cell for ``TRAIN_STEPS`` steps (its
    validation and checkpoint at the end), alone or through
    ``initialize_distributed`` as an NCCL group of world size 1 → each
    step's loss, host ms and applied gradients, the all-reduces, the model's
    state before each step and the final parameters; ``start_from``: such
    states, loaded before each step (as in :func:`recorded_steps`: K1's
    atomic order, which Adam's first updates amplify, would otherwise take
    two runs a trajectory apart)."""
    import torch

    from geneface_tpu_torch import parallel
    from geneface_tpu_torch.tasks.radnerf import RADNeRFTask
    from geneface_tpu_torch.training.trainer import Trainer

    fcfg = dict(train_cfg(cfg), work_dir=work, max_updates=TRAIN_STEPS,
                val_check_interval=TRAIN_STEPS, tb_log_interval=TRAIN_STEPS,
                num_sanity_val_steps=0, eval_max_batches=1, val_render_frame=False)
    saved = {k: os.environ.pop(k, None) for k in _DIST_ENV}
    if nccl:
        os.environ.update(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(free_port()))
    try:
        dev = parallel.initialize_distributed()
        if nccl and torch.distributed.get_backend() != ("nccl" if dev.type == "cuda" else "gloo"):
            raise AssertionError("the world-size-1 group on the card is not NCCL")
        task = RADNeRFTask(fcfg, device=dev)
        losses, ms, syncs, grads, states = [], [], [], [], []
        timed_sync(task, syncs)
        real = task.train_step

        def step(batch):
            if start_from is not None:
                task.model.load_state_dict(start_from[len(losses)])
            states.append({k: v.detach().cpu().clone()
                           for k, v in task.model.state_dict().items()})
            torch.cuda.synchronize()
            ts = time.perf_counter()
            out = real(batch)
            losses.append(float(out["total_loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - ts) * 1e3)
            # the gradients the optimizer applied (zeroed only by the next step)
            grads.append({n: p.grad.detach().float().cpu()
                          for n, p in task.model.named_parameters() if p.grad is not None})
            return out

        task.train_step = step
        Trainer(task).fit()
        params = {n: p.detach().float().cpu() for n, p in task.model.named_parameters()}
        mesh = parallel.data_size(task.mesh) if task.mesh is not None else 0
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    plain = [t for i, t in enumerate(ms) if i % 16 and i > 1]
    return {"losses": losses, "ms": ms, "median_ms": sorted(plain)[len(plain) // 2],
            "params": params, "mesh": mesh, "syncs": syncs, "grads": grads, "states": states}


def ddp_rank(rank: int, world: int, port: int, spec_path: str, out_dir: str) -> None:
    """One rank of the two-rank phase (``torch.multiprocessing.spawn``):
    join the gloo group on ``cuda:0``, run the steps and the frame-parallel
    render (the counted main path), then on rank 0 hold the card's results
    against the one-rank run's, profile one more step and capture the
    kernel sites of another; → ``<out_dir>/ddp_rank<rank>.pt``."""
    import torch

    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), GF_DIST_BACKEND="gloo")
    from torch.profiler import ProfilerActivity, profile

    from geneface_tpu_torch import parallel
    from geneface_tpu_torch.inference import radnerf_infer
    from geneface_tpu_torch.kernels import LAUNCHES
    from geneface_tpu_torch.tasks.radnerf import RADNeRFTask

    dev = parallel.initialize_distributed("cuda:0")
    if torch.distributed.get_backend() != "gloo" or torch.distributed.get_world_size() != world:
        raise AssertionError("the two-rank group is not gloo over two ranks")
    spec = torch.load(spec_path, weights_only=False)
    task = RADNeRFTask(spec["cfg"], device=dev, dtype=torch.float32)
    task.setup_mesh()
    task.build()
    task.place_state()
    syncs = []
    timed_sync(task, syncs)
    # the frame-parallel render keeps the float frames it gathers
    floats, writes = [], []
    real_gather, real_save = parallel.all_gather_slots, radnerf_infer.save_mp4

    def gather(mesh, x):
        out = real_gather(mesh, x)
        floats.append(out.cpu())
        return out

    def save(frames, out_path, **kw):
        writes.append(out_path)
        return real_save(frames, out_path, **kw)

    ref = torch.load(spec["ref_path"], weights_only=False)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    steps = recorded_steps(task, spec["batches"], start_from=ref["states"])
    radnerf_infer.parallel.all_gather_slots, radnerf_infer.save_mp4 = gather, save
    try:
        infer = radnerf_infer.RADNeRFInfer(spec["torso_cfg"], device=dev)
        t0 = time.perf_counter()
        mp4 = infer.render_video(n_frames=DDP_FRAMES, out_path=spec["mp4"])
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
    finally:
        radnerf_infer.parallel.all_gather_slots, radnerf_infer.save_mp4 = real_gather, real_save
    launches = dict(LAUNCHES)
    occ_equal = [bool(torch.equal(*parallel.all_gather_slots(task.mesh, x.float().reshape(-1))))
                 for x in task.occ]
    out = {"rank": rank, "launches": launches, "losses": steps["losses"], "ms": steps["ms"],
           "syncs": syncs, "occ_equal": occ_equal, "mp4": mp4, "writes": writes,
           "render_s": render_s}
    batch = spec["batches"][1]
    if rank == 0:
        out["loss_rel"] = [abs(a["total_loss"] - b["total_loss"]) / abs(b["total_loss"])
                           for a, b in zip(steps["losses"], ref["losses"])]
        out["grad_rel_l2"] = [grad_errors(g, r) for g, r in zip(steps["grads"], ref["grads"])]
        frames = torch.cat(floats)[:DDP_FRAMES]
        diff = (frames - ref["frames"]).abs()
        out["frames_max_abs"], out["frames_mean_abs"] = float(diff.max()), float(diff.mean())
        # one more step under the profiler (rank 0's kernels), then one captured
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _open_window()
            ts = time.perf_counter()
            task.train_step(batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - ts) * 1e3
        kernels, stages, busy = kernel_table(
            prof if any(us > 0 for _, us, _ in _device_events(prof)) else None)
        out["profile"] = {"wall_ms": wall, "device_busy_ms": busy, "stages_ms": stages,
                          "idle_share": None if busy is None else max(0.0, 1.0 - busy / wall),
                          "top_kernels": [[k[0][:100], k[1], k[2]] for k in kernels[:12]]}
        calls = capture_calls(lambda: task.train_step(batch))
        sites = name_sites(calls, grid_names(task.model), "ddp")
        out["sites"] = {s: (kernel, kind, tuple(a.cpu() if torch.is_tensor(a) else a
                                                 for a in args), kw)
                        for s, (kernel, kind, args, kw) in sites.items()}
    else:
        task.train_step(batch)  # rank 0's profiled step
        task.train_step(batch)  # rank 0's captured step
    torch.save(out, os.path.join(out_dir, f"ddp_rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def ddp_phase(cfg, out_dir: str, path: str = "ddp") -> tuple:
    """Data parallelism on the card: (a) the training cell's ``Trainer.fit``
    through an NCCL group of world size 1 against two runs without a
    process group; (b) two gloo ranks sharing ``cuda:0`` — 6 head steps
    with a sweep and 2 lip steps, each step started from the one-rank
    run's parameters and held against that run's step on the card, the
    all-reduce timed; (c) ``render_video`` of 4 torso
    frames split over the two ranks against the one-process render; →
    (record, launches, sites)."""
    import torch
    import torch.multiprocessing as mp

    from geneface_tpu_torch.inference import RADNeRFInfer
    from geneface_tpu_torch.tasks.radnerf import RADNeRFTask

    root = os.path.join(os.path.dirname(cfg["work_dir"]), "ddp")
    shutil.rmtree(root, ignore_errors=True)  # the fits would resume a run left here
    os.makedirs(root)
    # (a) NCCL at world size 1 against the plain run, each step from the
    # plain run's state, and a second plain run so started: the spread
    fits = {"plain_a": ddp_fit(cfg, os.path.join(root, "plain_a"), nccl=False)}
    states = fits["plain_a"].pop("states")
    for k in ("plain_b", "nccl"):
        fits[k] = ddp_fit(cfg, os.path.join(root, k), nccl=k == "nccl", start_from=states)
        del fits[k]["states"]
    del states
    if fits["nccl"]["mesh"] != 1 or fits["plain_a"]["mesh"] != 0:
        raise AssertionError(f"{path}: the NCCL run did not train on a mesh of one rank")

    def spread(x, y):
        per_grad = [grad_errors(g, r) for g, r in zip(x["grads"], y["grads"])]
        worst = [max(e.values()) for e in per_grad]
        flat = [torch.cat([v[n].double().reshape(-1) for n in sorted(v)])
                for v in (x["params"], y["params"])]
        loss = [abs(a - b) / abs(b) for a, b in zip(x["losses"], y["losses"])]
        at = max(range(len(worst)), key=worst.__getitem__)
        return {"loss_rel": max(loss), "grad_rel_l2": worst[at],
                "grad_rel_l2_at": f"step {at} {max(per_grad[at], key=per_grad[at].get)}",
                "params_rel_l2": float((flat[0] - flat[1]).norm() / flat[1].norm()),
                "per_step": loss, "per_step_grad": worst}

    def brief(d):
        return json.dumps({k: v for k, v in d.items() if not k.startswith("per_")})

    nccl_vs_plain = spread(fits["nccl"], fits["plain_a"])
    plain_vs_plain = spread(fits["plain_b"], fits["plain_a"])
    print(f"{path}: NCCL world size 1 vs the plain run over {TRAIN_STEPS} Trainer.fit steps, "
          f"each from the plain run's state: {brief(nccl_vs_plain)}; a second plain run so "
          f"started (K1's atomic order alone): {brief(plain_vs_plain)}")
    # (b)'s bounds: loss rel 1e-3 and gradient relative L2 0.1 on every
    # step, relative L2 0.1 of all the final parameters
    for key, bound in (("loss_rel", 1e-3), ("grad_rel_l2", 0.1), ("params_rel_l2", 0.1)):
        if not nccl_vs_plain[key] <= bound:
            raise AssertionError(f"{path}: the NCCL run left the plain run's bounds: {key} "
                                 f"{nccl_vs_plain[key]} (bound {bound}; two plain runs "
                                 f"{plain_vs_plain[key]})")
    nccl_ar = sorted(t for t, _ in fits["nccl"]["syncs"])
    print(f"{path}: median ms/step NCCL world 1 {fits['nccl']['median_ms']:.3f}, plain "
          f"{fits['plain_a']['median_ms']:.3f} / {fits['plain_b']['median_ms']:.3f} (Trainer.fit "
          f"of the train cell; steps without a sweep, first two left out); gradient "
          f"all-reduce {fits['nccl']['syncs'][0][1]} bytes, median "
          f"{nccl_ar[len(nccl_ar) // 2]:.3f} ms")
    record = {"nccl_vs_plain": nccl_vs_plain, "plain_vs_plain": plain_vs_plain,
              "nccl_median_step_ms": fits["nccl"]["median_ms"],
              "plain_median_step_ms": [fits["plain_a"]["median_ms"],
                                       fits["plain_b"]["median_ms"]],
              "nccl_allreduce": fits["nccl"]["syncs"]}
    del fits

    # (b), (c): the one-rank references on the card, then the two ranks
    dcfg = ddp_cfg(cfg)
    batches = ddp_batches(dcfg)
    ref_task = RADNeRFTask(dcfg, dtype=torch.float32)
    ref_task.build()
    ref = recorded_steps(ref_task, batches)
    del ref_task
    infer = RADNeRFInfer(torso_cfg(cfg))
    infer.prepare()
    ref["frames"] = torch.stack([infer.render_frame(i)["rgb_map"].float().reshape(HW, HW, 3).cpu()
                                 for i in range(DDP_FRAMES)])
    del infer
    ref_path, spec_path = os.path.join(root, "ref.pt"), os.path.join(root, "spec.pt")
    torch.save(ref, ref_path)
    torch.save({"cfg": dcfg, "batches": batches, "torso_cfg": torso_cfg(cfg),
                "mp4": os.path.join(root, "ddp_torso.mp4"), "ref_path": ref_path}, spec_path)
    torch.cuda.empty_cache()
    t0 = time.time()
    mp.spawn(ddp_rank, args=(DDP_WORLD, free_port(), spec_path, root), nprocs=DDP_WORLD,
             join=True)
    spawn_s = time.time() - t0
    ranks = [torch.load(os.path.join(root, f"ddp_rank{r}.pt"), weights_only=False)
             for r in range(DDP_WORLD)]
    r0 = ranks[0]
    launches = {k: sum(r["launches"][k] for r in ranks) for k in r0["launches"]}
    print(f"{path}: launches on the two ranks' counted steps and render "
          + json.dumps([r["launches"] for r in ranks]))
    if not all(launches.values()):
        raise AssertionError(f"{path}: a kernel was not launched: {launches}")
    if [r["launches"] for r in ranks] != [r0["launches"]] * DDP_WORLD:
        raise AssertionError(f"{path}: the ranks launched different kernels")
    worst = {s: max(e.values()) for s, e in enumerate(r0["grad_rel_l2"])}
    print(f"{path}: two gloo ranks on cuda:0 vs one rank (float32 MLPs, as the train "
          "phase's check; each step from the one-rank run's parameters), per step: loss rel "
          + json.dumps([f"{x:.3e}" for x in r0["loss_rel"]]) + ", worst gradient rel L2 "
          + json.dumps({s: f"{w:.3e} ({max(e, key=e.get)})"
                        for s, (w, e) in enumerate(zip(worst.values(), r0["grad_rel_l2"]))}))
    lips = [i for i, x in enumerate(r0["losses"]) if "lpips_loss" in x]
    sweeps = [i for i, x in enumerate(r0["losses"]) if x["occupancy_sweep"]]
    if lips != list(range(DDP_HEAD_STEPS, DDP_HEAD_STEPS + DDP_LIP_STEPS)) or sweeps != [0]:
        raise AssertionError(f"{path}: lip steps {lips}, sweeps {sweeps}")
    if max(r0["loss_rel"]) > 1e-3 or max(worst.values()) > 0.1:
        raise AssertionError(f"{path}: the two-rank steps left the one-rank run's bounds")
    if not all(all(r["occ_equal"]) for r in ranks):
        raise AssertionError(f"{path}: the occupancy grids differ across the ranks")
    if r0["losses"] != ranks[1]["losses"]:
        raise AssertionError(f"{path}: the ranks report different step metrics")
    ar = sorted(t for t, _ in r0["syncs"])
    head = [t for i, t in enumerate(r0["ms"]) if 1 < i < DDP_HEAD_STEPS]
    ref_head = [t for i, t in enumerate(ref["ms"]) if 1 < i < DDP_HEAD_STEPS]
    prof = r0["profile"]
    print(f"{path}: gradient all-reduce {r0['syncs'][0][1]} bytes per step, median "
          f"{ar[len(ar) // 2]:.3f} ms (gloo through the host); median ms/step "
          f"{sorted(head)[len(head) // 2]:.3f} on two ranks ({TRAIN_RAYS // DDP_WORLD} rays "
          f"each) vs {sorted(ref_head)[len(ref_head) // 2]:.3f} on one (steps 2-"
          f"{DDP_HEAD_STEPS - 1}); a profiled step: rank 0's kernels "
          f"{fmt_ms(prof['device_busy_ms'], ' ms')} of {prof['wall_ms']:.3f} ms wall (idle "
          f"share {fmt_ms(prof['idle_share'])}); spawn to end {spawn_s:.1f} s")
    if not (r0["frames_max_abs"] <= 1e-3 and r0["frames_mean_abs"] <= 1e-6):
        raise AssertionError(f"{path}: frame-parallel frames vs one process: max abs "
                             f"{r0['frames_max_abs']}, mean {r0['frames_mean_abs']}")
    if [len(r["writes"]) for r in ranks] != [1] + [0] * (DDP_WORLD - 1) or \
            not os.path.exists(r0["mp4"]):
        raise AssertionError(f"{path}: the mp4 was not written once by rank 0")
    print(f"{path}: render_video of {DDP_FRAMES} torso frames split over {DDP_WORLD} ranks "
          f"in {r0['render_s']:.3f} s vs one process: max abs {r0['frames_max_abs']:.3e}, "
          f"mean abs {r0['frames_mean_abs']:.3e}; the mp4 written once, by rank 0")
    record.update({
        "two_rank_loss_rel": r0["loss_rel"], "two_rank_worst_grad_rel_l2": worst,
        "two_rank_step_ms": r0["ms"], "one_rank_step_ms": ref["ms"],
        "allreduce": r0["syncs"], "profile": prof, "frames_max_abs": r0["frames_max_abs"],
        "frames_mean_abs": r0["frames_mean_abs"], "render_s": r0["render_s"],
        "launches_by_rank": [r["launches"] for r in ranks], "spawn_s": spawn_s,
    })
    sites = {s: (kernel, kind, tuple(a.cuda() if torch.is_tensor(a) else a for a in args), kw)
             for s, (kernel, kind, args, kw) in r0["sites"].items()}
    return record, launches, sites


def lip_cfg(cfg: dict) -> dict:
    """The lip cell: the training cell with the lip phase from step
    ``LIP_START`` (``base.yaml``'s patch size and LPIPS weight), seeded
    random LPIPS weights, and the sweep every 8 steps, so that step 8's
    sweep falls inside the phase, where it is frozen."""
    return dict(
        train_cfg(cfg), finetune_lips=True, finetune_lips_start_iter=LIP_START,
        lip_patch_size=LIP_PATCH, lambda_lpips_loss=0.01, allow_random_lpips=True,
        update_extra_interval=8,
    )


def lpips_vs_cpu(task, batch) -> dict:
    """The task's LPIPS alone on the card against a CPU copy (TF32 off) on
    the lip batch's ground-truth patch and a seeded perturbation of it: the
    distance and its gradient within 1e-5 of max |ref|; forward + backward
    ms by CUDA events."""
    import torch

    P = LIP_PATCH
    gt = torch.as_tensor(batch["gt_img_u8"]).float().reshape(1, P, P, 3) / 255.0
    noise = torch.randn(gt.shape, generator=torch.Generator().manual_seed(9))
    x = (gt + 0.05 * noise).clamp(0, 1)
    cpu = type(task.lpips)()
    cpu.load_state_dict({k: v.cpu() for k, v in task.lpips.state_dict().items()})
    out = {}
    for name, net, dev in (("cuda", task.lpips, task.device), ("cpu", cpu, "cpu")):
        xr = x.clone().to(dev).requires_grad_(True)
        d = net(xr, gt.to(dev))
        d.sum().backward()
        out[name] = (d.detach().cpu().double(), xr.grad.cpu().double())
    (dg, gg), (dc, gc) = out["cuda"], out["cpu"]
    res = {"distance_cuda": float(dg[0]), "distance_cpu": float(dc[0]),
           "distance_rel_err": float((dg - dc).abs().max() / dc.abs().max()),
           "grad_rel_err": float((gg - gc).abs().max() / gc.abs().max())}
    if not (res["distance_rel_err"] <= 1e-5 and res["grad_rel_err"] <= 1e-5):
        raise AssertionError(f"LPIPS card vs CPU: {res}")
    xc, gtc = x.clone().to(task.device).requires_grad_(True), gt.to(task.device)
    res["fwd_bwd_ms"] = events_ms(lambda: task.lpips(xc, gtc).sum().backward())
    res["fwd_ms"] = events_ms(lambda: task.lpips(xc.detach(), gtc))
    return res


def train_lip_phase(cfg, out_dir: str, path: str = "train_lip") -> tuple:
    """The lip phase of head training: ``RADNeRFTask.train_step`` for
    ``LIP_STEPS`` steps of the lip cell (the phase from step ``LIP_START``;
    the prefetching iterator makes every other step from step 6 a 64²
    lip patch of 4,096 rays), then a resume through ``Trainer.fit`` on the
    card; → (record, launches, sites)."""
    import numpy as np
    import torch

    from geneface_tpu_torch.kernels import LAUNCHES
    from geneface_tpu_torch.tasks.radnerf import RADNeRFTask
    from geneface_tpu_torch.training.optim import param_groups, radnerf_label_fn

    task = RADNeRFTask(lip_cfg(cfg))  # cuda, bf16 MLPs
    task.build()
    print(f"{path}: LPIPS weights are a seeded random init (allow_random_lpips): the "
          "released LPIPS weights are not in the repo")
    batches = task.train_batches()
    n_head, _ = n_grid_groups(task.model)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    step_ms, losses, lips, sweeps, occ_at = [], [], [], [], {}
    lip_batch = grad_check = None
    for i in range(LIP_STEPS):
        batch = next(batches)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = task.train_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3)
        lip = "lpips_loss" in out
        losses.append({k: float(out[k]) for k in ("total_loss", "mse_loss", "lpips_loss")
                       if k in out})
        if lip:
            lips.append(i)
            if lip_batch is None:  # the first lip step's gradients, by group
                lip_batch = batch
                grad_check = {g["name"]: sum(
                    int(p.grad is not None and bool((p.grad != 0).any())) for p in g["params"])
                    for g in param_groups(task.model, radnerf_label_fn,
                                          {"net": 1, "grid": 1, "att": 1})}
        if out["occupancy_sweep"]:
            sweeps.append(i)
        if task.in_lip_phase():
            occ_at[i] = [x.clone() for x in task.occ]
    launches = dict(LAUNCHES)
    print(f"{path}: lip steps {lips}, sweep steps {sweeps}; losses " + json.dumps(
        [{k: round(v, 6) for k, v in x.items()} for x in losses]))
    want = {"gather_rows": LIP_STEPS * (n_head + 1) + len(sweeps) * 16 * n_head,
            "scatter_add_rows": LIP_STEPS * (1 + n_head)}
    if launches != want:
        raise AssertionError(f"{path} launches {launches}, expected {want}")
    if lips != list(range(LIP_START + 2, LIP_STEPS, 2)) or sweeps != [0]:
        raise AssertionError(f"{path}: lip steps {lips}, sweeps {sweeps}")
    if not all(np.isfinite(v) for x in losses for v in x.values()):
        raise AssertionError(f"{path}: non-finite loss")
    if not all(losses[i]["lpips_loss"] > 0 for i in lips):
        raise AssertionError(f"{path}: an LPIPS loss is not positive")
    if not grad_check or not all(grad_check.values()):
        raise AssertionError(f"{path}: a parameter group has a zero gradient on a lip "
                             f"step: {grad_check}")
    first = min(occ_at)
    moved = [i for i in occ_at if not all(torch.equal(a, b) for a, b in
                                          zip(occ_at[i], occ_at[first]))]
    if moved:
        raise AssertionError(f"{path}: the occupancy moved inside the lip phase at {moved}")
    print(f"{path}: parameters with a non-zero gradient on lip step {lips[0]}, by group: "
          f"{grad_check}; occupancy bit-identical over steps {sorted(occ_at)}")
    lip_ms = sorted(step_ms[i] for i in lips)[len(lips) // 2]
    normal = [step_ms[i] for i in range(2, LIP_STEPS) if i not in lips and i not in sweeps]
    normal_ms = sorted(normal)[len(normal) // 2]
    print(f"{path}: median lip step {lip_ms:.3f} ms ({LIP_PATCH}² = "
          f"{LIP_PATCH * LIP_PATCH} rays), median normal step {normal_ms:.3f} ms "
          f"({task.cfg['n_rays']} rays; steps 2+ without a sweep)")
    record = {"step_ms": step_ms, "lip_steps": lips, "sweep_steps": sweeps,
              "median_lip_step_ms": lip_ms, "median_normal_step_ms": normal_ms,
              "losses": losses, "nonzero_grad_params_lip_step": grad_check}
    record["lpips"] = lpips_vs_cpu(task, lip_batch)
    print(f"{path}: LPIPS alone card vs CPU " + json.dumps(record["lpips"]))
    prof = profile_train_step(task, lip_batch, out_dir, lip_ms, path, lip=True)
    print(f"{path}: lip step device time {fmt_ms(prof['device_busy_ms'], ' ms')} of "
          f"{prof['wall_ms']:.3f} ms wall (idle share {fmt_ms(prof['idle_share'])}, "
          f"{prof['n_device_ops']} device operations); spans ms "
          + json.dumps({k: round(v, 3) for k, v in prof["stages_ms"].items()}))
    record.update(profile=prof,
                  grad_check=check_grads_vs_cpu(task, lip_batch, path, lip=True))
    # the kernel sites of one lip step
    sites = name_sites(capture_calls(lambda: task.train_step(lip_batch)),
                       grid_names(task.model), path)
    record["resume"] = resume_on_card(cfg, path)
    return record, launches, sites


def resume_on_card(cfg, path: str = "train_lip") -> dict:
    """``Trainer.fit`` of the lip cell to step 4 (validation and a
    checkpoint every 2 steps, each validation rendering a 512² val frame),
    then a fresh ``Trainer`` resumed to step 6: the optimizer state and
    ``task_step`` right after the restore equal the checkpoint's bit for
    bit; the best checkpoint, ``val/full_frame_psnr`` and the frames' images
    are written."""
    import numpy as np

    from geneface_tpu_torch.tasks.radnerf import RADNeRFTask
    from geneface_tpu_torch.training.trainer import Trainer
    from geneface_tpu_torch.utils.checkpoint import load_checkpoint

    work = os.path.join(os.path.dirname(cfg["work_dir"]), "work_lip")
    rcfg = dict(lip_cfg(cfg), work_dir=work, val_check_interval=2, tb_log_interval=2,
                num_sanity_val_steps=1, eval_max_batches=1, num_ckpt_keep=2)
    t0 = time.perf_counter()
    if Trainer(RADNeRFTask(dict(rcfg, max_updates=4))).fit() != 4:
        raise AssertionError(f"{path}: the first run did not reach step 4")
    t1 = time.perf_counter()
    saved = load_checkpoint(os.path.join(work, "model_ckpt_steps_4.ckpt"))
    task = RADNeRFTask(dict(rcfg, max_updates=6))
    seen = {}
    on_restore = task.on_restore

    def record_restore(extra):
        on_restore(extra)
        seen["opt"] = task.optimizer.state_dict()
        seen["task_step"] = task._step

    task.on_restore = record_restore
    if Trainer(task).fit() != 6:
        raise AssertionError(f"{path}: the resumed run did not reach step 6")
    t2 = time.perf_counter()
    opt = saved["state"]["opt_state"]
    diff = [k for k in ("count", "skipped") if not np.array_equal(seen["opt"][k], opt[k])]
    for k in ("mu", "nu"):
        from geneface_tpu_torch.convert import flax_to_state_dict

        a, b = flax_to_state_dict(seen["opt"][k]), flax_to_state_dict(opt[k])
        diff += [f"{k}:{n}" for n in b if n not in a or not np.array_equal(a[n], b[n])]
        diff += [f"{k}:{n}" for n in a if n not in b]
    if seen["task_step"] != saved["extra"]["task_step"]:
        diff.append("task_step")
    if diff:
        raise AssertionError(f"{path}: restored state differs from the checkpoint in {diff}")
    rows = [json.loads(x) for x in open(os.path.join(work, "metrics.jsonl"))]
    psnr = {r["step"]: r["val/full_frame_psnr"] for r in rows if "val/full_frame_psnr" in r}
    images = sorted(os.listdir(os.path.join(work, "images", "val_render")))
    files = sorted(os.listdir(work))
    if (sorted(psnr) != [2, 4, 6] or not all(np.isfinite(v) for v in psnr.values())
            or len(images) != 3 or "model_ckpt_best.ckpt" not in files
            or "model_ckpt_steps_6.ckpt" not in files):
        raise AssertionError(f"{path}: resume work dir {files}, images {images}, psnr {psnr}")
    res = {"first_run_s": t1 - t0, "resumed_run_s": t2 - t1, "full_frame_psnr": psnr,
           "images": images, "work_dir": files, "count": int(opt["count"]),
           "task_step": int(saved["extra"]["task_step"])}
    print(f"{path}: resume on the card passed: " + json.dumps(res))
    return res


def sweep_ms(task) -> float:
    """Wall time of one occupancy sweep (the head's density sweep, or the
    torso's alpha sweep) between CUDA events, the step counter set to a
    sweep step and restored."""
    import torch

    saved = task._step, task.occ, getattr(task, "torso_occ", None)
    task._step = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    task.maybe_update_occ()
    end.record()
    torch.cuda.synchronize()
    task._step = saved[0]
    task.set_occupancy(saved[1])
    if saved[2] is not None:
        task.torso_occ = saved[2]
    return start.elapsed_time(end)


def profile_train_step(task, batch, out_dir: str, wall_ms: float, path: str = "train",
                       lip: bool = False) -> dict:
    """One step without a sweep: the spans of forward, backward and
    optimizer on the device timeline (CUDA events, an unprofiled step), the
    render's ``gf::`` stage spans and the device time by kernel
    (``torch.profiler``, a second step; table in
    ``out_dir/<path>_step_profile.txt``); ``lip``: a lip step."""
    import torch
    from torch.profiler import ProfilerActivity

    def staged():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        dbatch = task.device_batch(batch, task._step)
        noises = torch.rand(dbatch["rays_o"].shape[0], generator=task.generator,
                            device=task.device)
        task.optimizer.zero_grad(set_to_none=True)
        loss, _ = task.loss_fn(dbatch, noises, train=True, **({"lip": True} if lip else {}))
        ev[1].record()
        loss.backward()
        ev[2].record()
        task.optimizer.step()
        ev[3].record()
        torch.cuda.synchronize()
        return {f"{n}_span": ev[i].elapsed_time(ev[i + 1])
                for i, n in enumerate(("forward", "backward", "optim"))}

    staged()
    spans = staged()
    kernels, stages, busy = kernel_table(
        profiled(staged, [ProfilerActivity.CPU, ProfilerActivity.CUDA]))
    stages.update(spans)
    with open(os.path.join(out_dir, f"{path}_step_profile.txt"), "w") as f:
        f.write(f"steady step wall {wall_ms:.3f} ms, device busy {fmt_ms(busy, ' ms')}\n")
        for name, ms in sorted(stages.items(), key=lambda s: -s[1]):
            f.write(f"stage {name:24s} {ms:9.3f} ms\n")
        for name, ms, n in kernels:
            f.write(f"{ms:9.3f} ms {n:5d}x {name}\n")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": None if busy is None else max(0.0, 1.0 - busy / wall_ms),
            "stages_ms": stages,
            "n_device_ops": sum(k[2] for k in kernels),
            "top_kernels": [[k[0][:100], k[1], k[2]] for k in kernels[:15]]}


#: the import cells: the keys of egs/datasets/videos/May/lm3d_radnerf_import.yaml
IMPORT_KEYS = dict(grid_num_levels=16, grid_level_dim=2, grid_backend="reference",
                   march_backend="walk", mean_samples_per_ray=0)
#: the step of the authored GeneFace checkpoint (a whole GeneFace head run)
IMPORT_STEP = 250000
#: the spread of the authored grids (100× the init's): the field depends on
#: them, and the block layout's jumps at its capped cells stay far below the
#: frame check's 1e-3
IMPORT_GRID_SPREAD = 0.01


def import_cfg(cfg: dict) -> dict:
    """The import cell: the full-width head+torso config under the keys of
    ``lm3d_radnerf_import.yaml``, its work dir the imported checkpoint's."""
    root = os.path.dirname(cfg["work_dir"])
    return dict(torso_cfg(cfg), **IMPORT_KEYS, work_dir=os.path.join(root, "work_import"),
                head_model_dir="")


def author_geneface_checkpoint(cfg: dict, path: str, seed: int = 3) -> str:
    """A GeneFace-format torso checkpoint (``{"state_dict": {"model": ...}}``,
    the reference's key names, ``torch.save``) at the config's full width,
    from seeded weights: grids uniform in ±``IMPORT_GRID_SPREAD``, the
    ``density_grid`` of the phase's planted ball and the planted
    ``density_grid_torso``; → the ``.ckpt`` path."""
    import numpy as np
    import torch

    from geneface_tpu_torch.models.radnerf import model_from_cfg
    from geneface_tpu_torch.utils.torch_import import reference_state_dict

    model = model_from_cfg(cfg, torso=True)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    sd = reference_state_dict(model)
    rng = np.random.RandomState(seed)
    for k in sd:
        if k.endswith("embedder.embeddings"):
            sd[k] = rng.uniform(-IMPORT_GRID_SPREAD, IMPORT_GRID_SPREAD,
                                sd[k].shape).astype(np.float32)
    sd["density_grid"] = planted_occupancy(cfg["grid_size"], cfg["density_thresh"])[0][0]
    sd["density_grid_torso"] = planted_torso_occupancy(cfg["grid_size"])[0]
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"model_ckpt_steps_{IMPORT_STEP}.ckpt")
    torch.save({"state_dict": {"model": {k: torch.from_numpy(v) for k, v in sd.items()}}}, out)
    return out


def import_serve_phase(cfg, out_dir: str, path: str = "import_serve") -> tuple:
    """A GeneFace user's first frame: a reference-format torso checkpoint
    authored at full width (:func:`author_geneface_checkpoint`), imported
    through ``utils/torch_import.py`` into a checkpoint of the port, then
    ``RADNeRFInfer`` under ``lm3d_radnerf_import.yaml``'s keys (the
    reference grid, the walk and the padded slab, with the cull): 4 frames
    counted and the steady frame; the same under ``grid_backend: block``;
    ``python -m geneface_tpu_torch.tools.validate_import`` on the
    checkpoint; each backend's frame held against the CPU plain path
    (:func:`serve_phase` for each backend); → (record, launches, sites)."""
    from geneface_tpu_torch.tools.validate_import import main as validate_main
    from geneface_tpu_torch.utils.torch_import import import_radnerf_checkpoint

    src_dir = os.path.join(os.path.dirname(cfg["work_dir"]), "geneface")
    t = time.perf_counter()
    src = author_geneface_checkpoint(cfg, src_dir)
    dst = import_radnerf_checkpoint(src_dir, cfg, cfg["work_dir"])
    import_s = time.perf_counter() - t
    print(f"{path}: authored {os.path.basename(src)} ({os.path.getsize(src) / 2**20:.1f} MiB) "
          f"and imported it as {os.path.relpath(dst, REPO)} in {import_s:.2f} s")
    record = {"import_s": import_s}
    launches = {"scatter_add_rows": 0, "gather_rows": 0}
    sites = {}
    for backend in ("reference", "block"):
        sub = path if backend == "reference" else f"{path}_block"
        record[backend], counted, found = serve_phase(dict(cfg, grid_backend=backend),
                                                      out_dir, sub)
        for k in launches:
            launches[k] += counted[k]
        sites.update(found)
    report = os.path.join(out_dir, f"{path}_validate_report.json")
    t = time.perf_counter()
    rc = validate_main(["--ckpt", src_dir, "--data_dir", cfg["data_dir"], "--frames", "1",
                        "--out", report] + _config_args(cfg, out_dir, path))
    with open(report) as f:
        rep = json.load(f)
    record["validate_import"] = dict(rep, s=time.perf_counter() - t)
    print(f"{path}: validate_import rc {rc} in {record['validate_import']['s']:.1f} s: "
          + json.dumps(rep["frames"]))
    if rc != 0 or not rep["pass"] or not rep["torso"]:
        raise AssertionError(f"{path}: validate_import failed: {rep}")
    return record, launches, sites


def _config_args(cfg: dict, out_dir: str, path: str) -> list:
    """``--config`` of a YAML holding ``cfg``'s model keys (the tool reads a
    config file)."""
    import yaml

    yml = os.path.join(out_dir, f"{path}_config.yaml")
    with open(yml, "w") as f:
        yaml.safe_dump({k: v for k, v in cfg.items() if k not in ("data_dir", "work_dir")}, f)
    return ["--config", yml]


def import_train_phase(cfg, out_dir: str, path: str = "import_train") -> tuple:
    """The fine-tune of an imported GeneFace head: the head of the
    checkpoint that :func:`import_serve_phase` authored, imported again as a
    head, restored into ``RADNeRFTask`` under ``lm3d_radnerf_import.yaml``'s
    keys (the reference grid, the walk, the padded slab) at step
    ``IMPORT_STEP``, then ``TRAIN_STEPS`` steps of 65,536 rays (sweeps at
    steps 0 and 16), every loss finite, every group's gradient non-zero,
    one step held against the CPU plain path; → (record, launches, sites)."""
    import numpy as np
    import torch

    from geneface_tpu_torch.kernels import LAUNCHES
    from geneface_tpu_torch.tasks.radnerf import RADNeRFTask
    from geneface_tpu_torch.training.optim import param_groups, radnerf_label_fn
    from geneface_tpu_torch.utils.checkpoint import load_checkpoint
    from geneface_tpu_torch.utils.torch_import import import_radnerf_checkpoint

    tcfg = dict(train_cfg(cfg), work_dir=os.path.join(os.path.dirname(cfg["work_dir"]),
                                                      "work_import_head"))
    src_dir = os.path.join(os.path.dirname(cfg["work_dir"]), "geneface")
    if not os.path.isdir(src_dir):  # without import_serve before it
        author_geneface_checkpoint(cfg, src_dir)
    ckpt = import_radnerf_checkpoint(src_dir, tcfg, tcfg["work_dir"], torso=False)
    task = RADNeRFTask(tcfg)  # cuda, bf16 MLPs
    task.build()
    task.restore_state(load_checkpoint(ckpt)["state"])
    task._step = IMPORT_STEP  # the fine-tune resumes at the checkpoint's step
    rk = task.render_kwargs()
    if rk["lattice_K"] is not None or rk["mean_samples_per_ray"]:
        raise AssertionError(f"{path}: not the walk and the padded slab: {rk}")
    batches = task.train_batches(IMPORT_STEP)
    interval = int(task.cfg["update_extra_interval"])
    n_head, _ = n_grid_groups(task.model)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    step_ms, losses, spr, sweeps = [], [], [], []
    for i in range(TRAIN_STEPS):
        batch = next(batches)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = task.train_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3)
        losses.append(float(out["total_loss"]))
        spr.append(float(out["mean_samples"]))
        if out["occupancy_sweep"]:
            sweeps.append(i)
    launches = dict(LAUNCHES)
    # per step one gather (forward) and one scatter (backward) per grid
    # level; per sweep one gather per level and chunk (16 chunks)
    want = {"gather_rows": TRAIN_STEPS * n_head + len(sweeps) * 16 * n_head,
            "scatter_add_rows": TRAIN_STEPS * n_head}
    if launches != want or sweeps != list(range(0, TRAIN_STEPS, interval)):
        raise AssertionError(f"{path} launches {launches}, expected {want}; sweeps {sweeps}")
    print(f"{path}: losses " + json.dumps([round(x, 6) for x in losses]))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{path}: non-finite training loss")
    nonzero = {g["name"]: sum(int(p.grad is not None and bool((p.grad != 0).any()))
                              for p in g["params"])
               for g in param_groups(task.model, radnerf_label_fn,
                                     {"net": 1, "grid": 1, "att": 1})}
    if not all(nonzero.values()):
        raise AssertionError(f"{path}: a parameter group has a zero gradient: {nonzero}")
    plain = [t for i, t in enumerate(step_ms) if i not in sweeps and i > 1]
    median = sorted(plain)[len(plain) // 2]
    print(f"{path}: median ms/step {median:.3f} (steps without a sweep, first two left "
          f"out); sweep steps {[round(step_ms[i], 3) for i in sweeps]} ms; "
          f"{TRAIN_RAYS / median * 1e3:.0f} rays/s; samples/ray per step (walk, slab of "
          f"{task.cfg['max_steps']}) " + json.dumps([round(x, 3) for x in spr])
          + f"; non-zero gradients by group {nonzero}")
    record = {"step_ms": step_ms, "median_step_ms": median, "losses": losses,
              "mean_samples_per_ray": spr, "rays_per_s": TRAIN_RAYS / median * 1e3,
              "nonzero_grad_params": nonzero}
    prof = profile_train_step(task, next(batches), out_dir, median, path)
    print(f"{path}: step device time {fmt_ms(prof['device_busy_ms'], ' ms')} of "
          f"{prof['wall_ms']:.3f} ms wall (idle share {fmt_ms(prof['idle_share'])}, "
          f"{prof['n_device_ops']} device operations); stage spans ms "
          + json.dumps({k: round(v, 3) for k, v in prof["stages_ms"].items()}))
    sweep = sweep_ms(task)
    print(f"{path}: sweep alone {sweep:.3f} ms (CUDA events, one unprofiled sweep)")
    record.update(profile=prof, sweep_ms=sweep,
                  grad_check=check_grads_vs_cpu(task, next(batches), path))
    if path == "train":
        record["data_ms"] = data_time(task.cfg, path)
    grids = grid_names(task.model)
    sites = name_sites(capture_calls(lambda: task.train_step(next(batches))), grids, path)
    saved_step = task._step
    task._step = interval * (saved_step // interval + 1)
    sites.update(name_sites(capture_calls(task.maybe_update_occ), grids, "import_sweep"))
    task._step = saved_step
    record["sweep_launches_per_site"] = 16
    return record, launches, sites


# ------------------------------------------------------------------ datagen --
DATAGEN_FRAMES = 100  # 4 s at 25 fps
DATAGEN_HW = 512
DATAGEN_SECONDS = 4.0
#: BFM09 ``BFM_model_front.mat``: vertices, triangles; ReconNet's id, exp
#: and tex head widths
BFM_VERTICES, BFM_TRIS = 35709, 70789
BFM_DIMS = (80, 64, 80)
DATAGEN_FOCAL = 1200.0  # the planted focal, one of fit_sequence's candidates
DATAGEN_CHECK_FRAMES = 2
DATAGEN_TRAIN_STEPS = 2
#: refine_photometric's defaults: photo_batch, global and per-frame steps
DATAGEN_PHOTO_BATCH, PHOTO_GLOBAL_STEPS, PHOTO_FRAME_STEPS = 50, 150, 80
#: a photometric gradient, card vs CPU at the same parameters: max abs
#: difference over max |CPU| by key (the geometry's matrix products round
#: differently on the two devices, which moves splat weights by a few ulp)
DATAGEN_GRAD_BOUND = 1e-3


def bfm_sized_basis(seed: int = 0) -> dict:
    """A seeded vertex-level 3DMM at BFM09's front widths (numpy): a
    sphere-cap shell of radius 0.8 on a 190-column grid cut to 35,709
    vertices, its grid triangles (70,664) topped up to 70,789 with the other
    diagonal of the first quads, smooth random bases (each column a
    low-frequency field over the shell, 0.01 per unit), a patterned albedo
    and 68 landmark vertices."""
    import numpy as np

    rng = np.random.RandomState(seed)
    cols = 190
    rows = -(-BFM_VERTICES // cols)
    r, c = np.divmod(np.arange(BFM_VERTICES), cols)
    th = -0.6 + 1.2 * r / (rows - 1)
    ph = -0.7 + 1.4 * c / (cols - 1)
    x = 0.8 * np.sin(th)
    y = 0.8 * np.sin(ph) * 1.15
    z = -0.8 * np.cos(th) * np.cos(ph)
    tris, extra = [], []
    for i in range(rows - 1):
        for j in range(cols - 1):
            a, b = i * cols + j, i * cols + j + 1
            cc, d = a + cols, b + cols
            if d < BFM_VERTICES:
                tris += [(a, b, cc), (b, d, cc)]
                extra += [(a, b, d), (a, d, cc)]
    tris = np.asarray(tris + extra[: BFM_TRIS - len(tris)], np.int64)
    assert tris.shape == (BFM_TRIS, 3), tris.shape

    def fields(k):  # [V*3, k] smooth columns
        f = rng.uniform(1.0, 4.0, (2, 3, k))
        p = rng.uniform(0, 2 * np.pi, (3, k))
        out = np.sin(x[:, None, None] * f[0] + y[:, None, None] * f[1] + p)  # [V, 3, k]
        return (0.01 * out).reshape(-1, k).astype(np.float32)

    albedo = np.stack([0.55 + 0.35 * np.sin(4.0 * x) * np.cos(3.0 * y),
                       0.45 + 0.30 * np.cos(5.0 * x + 1.0),
                       0.40 + 0.30 * np.sin(3.0 * y + 0.5)], -1)
    return {"mean": np.stack([x, y, z], -1).reshape(-1).astype(np.float32),
            "id_base": fields(BFM_DIMS[0]), "exp_base": fields(BFM_DIMS[1]),
            "tex_mean": albedo.reshape(-1).astype(np.float32), "tex_base": fields(BFM_DIMS[2]),
            "tris": tris,
            "lm_index": np.linspace(cols * 10, BFM_VERTICES - cols * 10, 68).astype(np.int64)}


def datagen_bases(b: dict, device) -> tuple:
    """(``FullFaceBasis``, its landmark ``FaceBasis``) on ``device``."""
    import numpy as np
    import torch

    from geneface_tpu_torch.datagen.face_renderer import FullFaceBasis
    from geneface_tpu_torch.datagen.face_tracker import FaceBasis

    fb = FullFaceBasis(**{k: torch.as_tensor(v, device=device) for k, v in b.items()})
    sel = np.stack([3 * b["lm_index"] + k for k in range(3)], -1).reshape(-1)
    lb = FaceBasis(*(torch.as_tensor(b[k][sel], device=device)
                     for k in ("mean", "id_base", "exp_base")))
    return fb, lb


def planted_video(fb, lb, seed: int = 1) -> tuple:
    """100 frames of 512²: the basis rendered on the card at known smooth
    parameters and ``DATAGEN_FOCAL`` (the soft splat at scale 4, upsampled
    nearest, as the JAX package's photometric test plants its frames) over a
    seeded background → (uint8 frames, the planted landmarks [T, 68, 2])."""
    import numpy as np
    import torch

    from geneface_tpu_torch.datagen import face_renderer as R
    from geneface_tpu_torch.datagen.face_tracker import _cam_geometry, project_landmarks

    rng = np.random.RandomState(seed)
    T, HW = DATAGEN_FRAMES, DATAGEN_HW
    t = np.arange(T)[:, None]
    freq = rng.uniform(0.05, 0.3, (1, BFM_DIMS[1]))
    planted = {
        "id": rng.randn(BFM_DIMS[0]) * 0.5,
        "exp": np.sin(t * freq + rng.uniform(0, 6.3, (1, BFM_DIMS[1]))) * 0.5,
        "euler": np.concatenate([0.12 * np.sin(t * 0.11), 0.10 * np.cos(t * 0.07),
                                 0.05 * np.sin(t * 0.05)], -1),
        "trans": np.concatenate([0.06 * np.sin(t * 0.06), 0.05 * np.cos(t * 0.09),
                                 7.0 + 0.15 * np.sin(t * 0.04)], -1),
        "tex": rng.randn(BFM_DIMS[2]) * 0.5,
        "light": np.tile(np.eye(1, 27, 2) * 0.3 + rng.randn(1, 27) * 0.05, (T, 1)),
    }
    planted = {k: np.asarray(v, np.float32) for k, v in planted.items()}
    dev = fb.mean.device
    p = {k: torch.as_tensor(v, device=dev) for k, v in planted.items()}
    cxy = torch.tensor([HW / 2.0, HW / 2.0], device=dev)
    frames = []
    with torch.no_grad():
        albedo = (fb.tex_mean + p["tex"] @ fb.tex_base.T).reshape(1, -1, 3)
        for lo in range(0, T, DATAGEN_PHOTO_BATCH):
            sl = slice(lo, lo + DATAGEN_PHOTO_BATCH)
            cam = _cam_geometry(fb, p["id"], p["exp"][sl], p["euler"][sl], p["trans"][sl])
            colors = albedo * R.sh9_irradiance(R.vertex_normals(cam, fb.tris), p["light"][sl])
            rgb, w = R.render_vertices_soft(cam, colors, DATAGEN_FOCAL, cxy, HW, HW, scale=4)
            frames.append(torch.cat([rgb.clamp(0, 1), (w > 0.05)[..., None].float()], -1))
        face = torch.cat(frames).repeat_interleave(4, 1).repeat_interleave(4, 2)
        g = torch.Generator(device=dev).manual_seed(seed)
        bg = torch.rand(1, 3, HW // 32, HW // 32, device=dev, generator=g)
        bg = torch.nn.functional.interpolate(bg, size=(HW, HW), mode="bilinear")
        bg = bg.permute(0, 2, 3, 1) * 0.6 + 0.2
        rgb = torch.where(face[..., 3:] > 0, face[..., :3], bg)
        video = (rgb * 255).round().to(torch.uint8).cpu().numpy()
        lms = project_landmarks(lb, p["id"], p["exp"], p["euler"], p["trans"],
                                DATAGEN_FOCAL, cxy).cpu().numpy()
    return video, lms


def datagen_phase(cfg, out_dir: str, path: str = "datagen") -> tuple:
    """A person's dataset made on the card: a seeded BFM-sized basis, a
    planted 100-frame 512² video and a 4 s wav, through ``process_frames``
    (mel, f0, HuBERT-large; BiSeNet as ``parse_fn``; the planted landmarks
    as ``lm_fn``; ``fit_sequence`` and ``refine_photometric`` at their
    defaults), FAN on every frame, ``extract_3dmm_coeffs`` and
    ``binarize_video``; then the store loaded and 2 ``RADNeRFTask`` steps on
    it. Every stage timed; the networks, the renderer, one photometric
    gradient and the focal search held against the CPU plain path →
    (record, launches, sites)."""
    import numpy as np
    import torch

    from geneface_tpu_torch import resolve_device
    from geneface_tpu_torch.datagen import extract_3dmm_coeffs
    from geneface_tpu_torch.datagen import face_tracker as FT
    from geneface_tpu_torch.datagen.binarizer import binarize_video
    from geneface_tpu_torch.datagen.face_landmarker import FAN, FANLandmarker
    from geneface_tpu_torch.datagen.face_parser import BiSeNet, parse_frame
    from geneface_tpu_torch.datagen.face_recon import ReconNet, Reconstructor
    from geneface_tpu_torch.datagen.process import process_frames
    from geneface_tpu_torch.kernels import LAUNCHES
    from geneface_tpu_torch.models.layers import init_weights_
    from geneface_tpu_torch.tasks.radnerf import RADNeRFTask
    from geneface_tpu_torch.training.optim import param_groups, radnerf_label_fn

    dev = resolve_device()
    root = os.path.dirname(cfg["work_dir"])
    work = os.path.join(root, "datagen")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    b = bfm_sized_basis()
    fb, lb = datagen_bases(b, dev)
    video, planted_lms = planted_video(fb, lb)
    audio = os.path.join(root, "audio")
    hubert = os.path.join(audio, "hubert.pkl")
    if not os.path.exists(hubert):
        hubert = write_audio_models(audio)["hubert"]
    os.environ["GF_HUBERT_CKPT"] = hubert
    wav = os.path.join(work, "speech.wav")
    write_voiced_wav(wav, DATAGEN_SECONDS, seed=2)
    gen = torch.Generator().manual_seed(5)
    parser = init_weights_(BiSeNet(), gen).to(dev).eval()
    fan = FANLandmarker(init_weights_(FAN(), gen), device=dev)
    recon = Reconstructor(init_weights_(ReconNet(), gen), device=dev)
    setup_s = time.perf_counter() - t0
    print(f"{path}: basis {BFM_VERTICES} vertices, {BFM_TRIS} triangles, id/exp/tex "
          f"{BFM_DIMS}; planted video {video.shape} at focal {DATAGEN_FOCAL}; set-up "
          f"{setup_s:.1f} s")

    # the main path, counted: process_frames → FAN → 3DMM coefficients → store
    timings = {"parse_s": 0.0, "track_s": 0.0, "photo_s": 0.0}  # and each's last output
    real_fit, real_refine = FT.fit_sequence, FT.refine_photometric

    def timed(fn, key):
        def call(*a, **k):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            timings[key] += time.perf_counter() - ts
            timings[key + "_out"] = out
            return out
        return call

    lm_iter = iter(planted_lms)
    parse_fn = timed(lambda f: parse_frame(parser, f), "parse_s")
    FT.fit_sequence, FT.refine_photometric = (timed(real_fit, "track_s"),
                                              timed(real_refine, "photo_s"))
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    try:
        t1 = time.perf_counter()
        man = process_frames(video, os.path.join(work, "proc"), parse_fn=parse_fn,
                             lm_fn=lambda f: next(lm_iter), basis=lb, full_basis=fb,
                             wav_path=wav)
        process_s = time.perf_counter() - t1
    finally:
        FT.fit_sequence, FT.refine_photometric = real_fit, real_refine
    ts = time.perf_counter()
    fan_lms = np.stack([fan(video[t], man["masks"][t]) for t in range(DATAGEN_FRAMES)])
    fan_s = time.perf_counter() - ts
    ts = time.perf_counter()
    coeffs = extract_3dmm_coeffs(video, man["lms"], recon, batch_size=32)
    recon_s = time.perf_counter() - ts
    store = os.path.join(work, "store")
    binarize_video(man, store, basis=lb)
    chunk = min(DATAGEN_PHOTO_BATCH, DATAGEN_FRAMES)
    n_photo_steps = PHOTO_GLOBAL_STEPS + PHOTO_FRAME_STEPS * -(-DATAGEN_FRAMES // chunk)
    want = {"scatter_add_rows": 2 * n_photo_steps, "gather_rows": 2 * n_photo_steps}
    launches = dict(LAUNCHES)
    if launches != want:
        raise AssertionError(f"{path} launches {launches}, expected {want} (normals and splat, "
                             "forward and backward, per photometric step)")
    track = man["track"]
    audio_shapes = {k: None if v is None else list(v.shape) for k, v in man["audio"].items()}
    if not np.isfinite(track["photo_loss"]):
        raise AssertionError(f"{path}: photo loss {track['photo_loss']}")
    if (coeffs.shape != (DATAGEN_FRAMES, 257) or not np.isfinite(coeffs).all()
            or not np.isfinite(fan_lms).all() or None in audio_shapes.values()):
        raise AssertionError(f"{path}: coeffs {coeffs.shape}, FAN finite "
                             f"{np.isfinite(fan_lms).all()}, audio {audio_shapes}")
    T = DATAGEN_FRAMES
    stage = {"parse_ms_per_frame": timings["parse_s"] / T * 1e3,
             "fan_ms_per_frame": fan_s / T * 1e3, "recon_ms_per_frame": recon_s / T * 1e3,
             "track_s": timings["track_s"], "photo_s": timings["photo_s"],
             "photo_ms_per_step": timings["photo_s"] / n_photo_steps * 1e3,
             "process_frames_s": process_s}
    print(f"{path}: process_frames {process_s:.3f} s; ms/frame parse "
          f"{stage['parse_ms_per_frame']:.3f}, FAN {stage['fan_ms_per_frame']:.3f}, recon "
          f"{stage['recon_ms_per_frame']:.3f} (alignment on the host included); landmark fit "
          f"{timings['track_s']:.3f} s, refinement {timings['photo_s']:.3f} s "
          f"({n_photo_steps} steps, {stage['photo_ms_per_step']:.3f} ms/step); focal "
          f"{track['focal']} (planted {DATAGEN_FOCAL}), landmark loss {track['loss']:.4f}, "
          f"photo loss {track['photo_loss']:.6f}; audio " + json.dumps(audio_shapes))

    # the store trains: RADNeRFDataset loads it, 2 RADNeRFTask steps from the
    # head checkpoint (its planted occupancy ball). The store's c2w is the
    # tracker's camera (+z forward) where the dataset reads the NeRF's (-z
    # forward), as the JAX package writes it (ROADMAP, Queue 3): its rays
    # look away from the head. The cell mirrors the cameras through the head
    # with the dataset's camera_scale and camera_offset (at the synthetic
    # scene's distance, 0.6 before the ngp scale of 4), so that the rays
    # cross the occupancy and every group gets a gradient
    from geneface_tpu_torch.utils.camera import nerf_matrix_to_ngp

    c2w = np.stack([s["c2w"] for s in np.load(os.path.join(store, "trainval_dataset.npy"),
                                              allow_pickle=True).item()["train_samples"]])
    scale = 0.6 * 4.0 / float(np.linalg.norm(c2w[:, :3, 3], axis=-1).mean())
    origin = np.mean([nerf_matrix_to_ngp(m, scale=scale)[:3, 3] for m in c2w], 0)
    tcfg = train_cfg(dict(cfg, data_dir=store, work_dir=os.path.join(work, "train"),
                          camera_scale=scale, camera_offset=(-2.0 * origin).tolist()))
    os.makedirs(tcfg["work_dir"], exist_ok=True)
    shutil.copy(os.path.join(cfg["work_dir"], "model_ckpt_steps_0.ckpt"), tcfg["work_dir"])
    ts = time.perf_counter()
    task = RADNeRFTask(tcfg)
    task.build()
    batches = task.train_batches()
    losses = [float(task.train_step(next(batches))["total_loss"])
              for _ in range(DATAGEN_TRAIN_STEPS)]
    nonzero = {g["name"]: sum(int(p.grad is not None and bool((p.grad != 0).any()))
                              for p in g["params"])
               for g in param_groups(task.model, radnerf_label_fn,
                                     {"net": 1, "grid": 1, "att": 1})}
    if not all(np.isfinite(losses)) or not all(nonzero.values()):
        raise AssertionError(f"{path}: store training losses {losses}, non-zero gradients "
                             f"by group {nonzero}")
    train_s = time.perf_counter() - ts
    train_launches = {k: LAUNCHES[k] - launches[k] for k in LAUNCHES}
    launches = dict(LAUNCHES)
    print(f"{path}: the store ({len(task.train_ds.samples)} train frames) trains: losses {[round(x, 6) for x in losses]}, parameters with a "
          f"non-zero gradient by group {nonzero}, launches {train_launches}")

    ts = time.perf_counter()
    checks = datagen_checks(path, parser, fan, recon, video, man, fb, lb,
                            timings["track_s_out"])
    checks_s = time.perf_counter() - ts
    ts = time.perf_counter()
    prof = datagen_profiles(path, out_dir, parser, fan, recon, video, man, fb, lb)
    print(f"{path}: store training {train_s:.1f} s, card-vs-CPU checks {checks_s:.1f} s, "
          f"profiles {time.perf_counter() - ts:.1f} s")

    # the kernel sites of one photometric step (50 frames)
    sites = name_sites(capture_calls(lambda: photo_step(fb, man, video, range(
        DATAGEN_PHOTO_BATCH))), {}, path)
    record = {"stages": stage, "launches_datagen": want, "launches_store_train": train_launches,
              "focal": track["focal"], "landmark_loss": track["loss"],
              "photo_loss": track["photo_loss"], "store_train_losses": losses,
              "nonzero_grad_params": nonzero, "card_vs_cpu": checks, "profile": prof}
    return record, launches, sites


def photo_inputs(fb, man, video, ids, device) -> tuple:
    """(params, frames_ds, lms, focal, cxy) of ``_photo_loss`` at the
    refined track for the frames ``ids``, on ``device``."""
    import numpy as np
    import torch

    from geneface_tpu_torch.datagen.face_renderer import downsample_frames

    ids = np.asarray(list(ids))
    tr = man["track"]

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    params = {"id": f32(tr["id"]), "exp": f32(tr["exp"][ids]), "euler": f32(tr["euler"][ids]),
              "trans": f32(tr["trans"][ids]), "tex": f32(tr["tex"]), "light": f32(tr["light"][ids])}
    frames_ds = f32(downsample_frames(video[ids].astype(np.float32) / 255.0, 4))
    hw = DATAGEN_HW
    return (params, frames_ds, f32(man["lms"][ids]), torch.tensor(float(tr["focal"]), device=device),
            torch.tensor([hw / 2.0, hw / 2.0], device=device))


def photo_step(fb, man, video, ids, params=None) -> tuple:
    """One ``_photo_loss`` forward and backward on ``fb``'s device →
    (total, terms, gradients by key)."""
    import torch

    from geneface_tpu_torch.datagen.face_tracker import _photo_loss

    p, frames_ds, lms, focal, cxy = photo_inputs(fb, man, video, ids, fb.mean.device)
    p = {k: v.requires_grad_(True) for k, v in (params or p).items()}
    total, aux = _photo_loss(p, fb, frames_ds, lms, focal, cxy, DATAGEN_HW, DATAGEN_HW, 4,
                             1.0, 1e-3, 1.0, 1e-3, 1e-3, 0.05)
    grads = torch.autograd.grad(total, list(p.values()))
    return total.detach(), {k: v.detach() for k, v in aux.items()}, dict(zip(p, grads))


def datagen_checks(path, parser, fan, recon, video, man, fb, lb, lm_track) -> dict:
    """The card against the port's plain CPU path on the card's inputs."""
    import copy

    import numpy as np
    import torch

    from geneface_tpu_torch.datagen import face_renderer as R
    from geneface_tpu_torch.datagen import face_tracker as FT
    from geneface_tpu_torch.datagen.face_parser import parse_logits
    from geneface_tpu_torch.ops.scatter import scatter_add_rows_plain

    cpu = torch.device("cpu")
    out = {}
    n = DATAGEN_CHECK_FRAMES
    # the networks on 2 frames, within 1e-5 of max |ref| (TF32 off)
    card_logits = parse_logits(parser, video[:n])
    cpu_logits = parse_logits(copy.deepcopy(parser).to(cpu), video[:n])
    out["bisenet"] = held("BiSeNet logits", card_logits, cpu_logits, 1e-5, path=path)
    flips = int((card_logits.argmax(-1).cpu() != cpu_logits.argmax(-1)).sum())
    crops = np.stack([fan.crop(video[t], man["masks"][t])[0] for t in range(n)])
    cpu_fan = copy.deepcopy(fan)
    cpu_fan.model, cpu_fan.device = cpu_fan.model.to(cpu), cpu
    out["fan"] = held("FAN heatmaps", fan.heatmaps(crops), cpu_fan.heatmaps(crops), 1e-5,
                      path=path)
    aligned = np.stack([recon.preprocess(video[t], man["lms"][t]) for t in range(n)])
    cpu_recon = copy.deepcopy(recon)
    cpu_recon.net, cpu_recon.device = cpu_recon.net.to(cpu), cpu
    out["recon"] = held("ReconNet coefficients", recon.coeffs(aligned),
                        cpu_recon.coeffs(aligned), 1e-5, path=path)
    print(f"{path}: BiSeNet argmax of {flips} of {n * DATAGEN_HW ** 2} pixels in another "
          "class on the card than on the CPU (near ties)")
    out["mask_pixels_differing"] = flips

    # the renderer at the card's geometry and colours (50 frames): weights
    # and colours held to K1's rounding bound on the CPU's splat updates
    ids = range(DATAGEN_PHOTO_BATCH)
    p, _, _, focal, cxy = photo_inputs(fb, man, video, ids, fb.mean.device)
    with torch.no_grad():
        cam = FT._cam_geometry(fb, p["id"], p["exp"], p["euler"], p["trans"])
        albedo = (fb.tex_mean + p["tex"] @ fb.tex_base.T).reshape(1, -1, 3)
        colors = albedo * R.sh9_irradiance(R.vertex_normals(cam, fb.tris), p["light"])
        rgb, w = R.render_vertices_soft(cam, colors, focal, cxy, DATAGEN_HW, DATAGEN_HW, scale=4)
    cpu_args = (cam.cpu(), colors.cpu(), focal.cpu(), cxy.cpu(), DATAGEN_HW, DATAGEN_HW)
    calls = capture_calls(lambda: R.render_vertices_soft(*cpu_args, scale=4))
    rgb_c, w_c = R.render_vertices_soft(*cpu_args, scale=4)
    _, (rows, upd, n_rows), _, _ = next(c for c in calls if c[2] == ("datagen", "splat"))
    kept = (rows >= 0) & (rows < n_rows)
    cnt = torch.bincount(rows[kept].long(), minlength=n_rows).float()[:, None]
    mag = scatter_add_rows_plain(rows, upd.abs(), n_rows)
    # two summation orders (2·n·2^-24·Σ|u|) and the updates' own last bit
    # (exp on two math libraries: 2^-22·Σ|u|)
    bound = (2.0 * cnt * 2.0**-24 + 2.0**-22) * mag  # [B·h·w, 4]
    bw = bound[:, 3].reshape(w_c.shape)
    dw = (w.cpu() - w_c).abs()
    if bool((dw > bw).any()):
        raise AssertionError(f"{path}: splat weights card vs CPU beyond the rounding bound: "
                             f"{int((dw > bw).sum())} pixels, max {float(dw.max()):.3e}")
    # colour = sums / weight: its bound is (b_sum + |rgb|·b_w) / w, plus its own rounding
    covered = w_c > 0.05
    brgb = ((bound[:, :3].reshape(rgb_c.shape) + rgb_c.abs() * bw[..., None])
            / w_c.clamp_min(1e-8)[..., None] + 2.0**-22 * rgb_c.abs())
    drgb = (rgb.cpu() - rgb_c).abs()
    bad = int(((drgb > brgb) & covered[..., None]).sum())
    if bad:
        raise AssertionError(f"{path}: splat colours card vs CPU beyond the bound at {bad} values")
    out["splat_weight_max_abs"] = float(dw.max())
    out["splat_rgb_max_abs_covered"] = float(drgb[covered].max())
    print(f"{path}: splat of {DATAGEN_PHOTO_BATCH} frames card vs CPU (the card's geometry): "
          f"weight max abs {out['splat_weight_max_abs']:.3e}, colour max abs "
          f"{out['splat_rgb_max_abs_covered']:.3e} on {int(covered.sum())} covered pixels, "
          "every value inside the rounding bound")

    # one photometric gradient at the card's parameters (50 frames)
    total, _, g_card = photo_step(fb, man, video, ids)
    fb_cpu = fb.to(cpu)
    total_c, _, g_cpu = photo_step(fb_cpu, man, video, ids)
    rel = {k: float((g_card[k].cpu() - g_cpu[k]).abs().max() / g_cpu[k].abs().max())
           for k in g_cpu}
    out["photo_grad_rel"] = rel
    out["photo_loss_rel"] = float(abs(total.cpu() - total_c) / abs(total_c))
    print(f"{path}: photometric loss card vs CPU rel {out['photo_loss_rel']:.3e}; gradient max "
          "abs / max |CPU| by key " + json.dumps({k: f"{v:.3e}" for k, v in rel.items()})
          + f" (bound {DATAGEN_GRAD_BOUND})")
    if not out["photo_loss_rel"] <= 1e-5 or not max(rel.values()) <= DATAGEN_GRAD_BOUND:
        raise AssertionError(f"{path}: photometric step card vs CPU {out['photo_loss_rel']}, "
                             f"{rel}")

    # the focal search on the CPU from the same landmarks
    ts = time.perf_counter()
    cpu_track = FT.fit_sequence(man["lms"], lb.to(cpu), DATAGEN_HW, DATAGEN_HW, device="cpu")
    out["cpu_focal"] = cpu_track["focal"]
    out["cpu_fit_s"] = time.perf_counter() - ts
    if cpu_track["focal"] != man["track"]["focal"]:
        raise AssertionError(f"{path}: focal card {man['track']['focal']} vs CPU "
                             f"{cpu_track['focal']}")
    print(f"{path}: fit_sequence on the CPU picks focal {cpu_track['focal']} as the card "
          f"({out['cpu_fit_s']:.1f} s; landmark loss CPU {cpu_track['loss']:.5f}, card "
          f"{man['track']['loss']:.5f})")

    # the refinement lowers the colour loss of the landmark-only track
    def col_loss(track) -> float:
        m = dict(man, track=track)
        terms = [photo_step(fb, m, video, range(lo, lo + DATAGEN_PHOTO_BATCH))[1]["col"]
                 for lo in range(0, DATAGEN_FRAMES, DATAGEN_PHOTO_BATCH)]
        return float(sum(terms)) / len(terms)

    tex_dim, T = fb.tex_base.shape[1], DATAGEN_FRAMES
    before = col_loss(dict(lm_track, tex=np.zeros(tex_dim, np.float32),
                           light=np.zeros((T, 27), np.float32)))
    after = col_loss(man["track"])
    out["col_loss_landmark_only"], out["col_loss_refined"] = before, after
    print(f"{path}: colour loss over the {T} planted frames: landmark-only track {before:.6f}, "
          f"refined {after:.6f}")
    if not (np.isfinite(after) and after < before):
        raise AssertionError(f"{path}: refined colour loss {after} not below {before}")
    return out


def datagen_profiles(path, out_dir, parser, fan, recon, video, man, fb, lb) -> dict:
    """Device busy and idle share of one photometric step (50 frames,
    forward, backward and Adam; table to ``<path>_photo_step_profile.txt``)
    and the ``gf::`` span of each stage in a window of its own."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity

    from geneface_tpu_torch.datagen import face_tracker as FT
    from geneface_tpu_torch.datagen.face_parser import parse_logits

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ids = range(DATAGEN_PHOTO_BATCH)
    p, frames_ds, lms, focal, cxy = photo_inputs(fb, man, video, ids, fb.mean.device)

    def step(n=1):
        return FT._photo_fit(fb, frames_ds, lms, focal, cxy, p, steps=n, lr=0.005,
                             H=DATAGEN_HW, W=DATAGEN_HW, scale=4, frozen=("id", "tex"))

    step(2)
    torch.cuda.synchronize()
    ts = time.perf_counter()
    step(10)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - ts) / 10 * 1e3
    kernels, spans, busy = kernel_table(profiled(step, acts))
    with open(os.path.join(out_dir, f"{path}_photo_step_profile.txt"), "w") as f:
        f.write(f"photometric step (50 frames, frozen id/tex) wall {wall:.3f} ms, device busy "
                f"{fmt_ms(busy, ' ms')}\n")
        for name, ms in sorted(spans.items(), key=lambda s: -s[1]):
            f.write(f"stage {name:24s} {ms:9.3f} ms\n")
        for name, ms, n in kernels:
            f.write(f"{ms:9.3f} ms {n:5d}x {name}\n")
    idle = None if busy is None else max(0.0, 1.0 - busy / wall)
    crop = fan.crop(video[0], man["masks"][0])[0][None]
    aligned = np.stack([recon.preprocess(video[t], man["lms"][t])
                        for t in range(min(32, DATAGEN_FRAMES))])
    windows = {
        "gf::parse": lambda: parse_logits(parser, video[:1]),
        "gf::fan": lambda: fan.heatmaps(crop),
        "gf::recon": lambda: recon.coeffs(aligned),
        # a tenth of the fit's steps: the whole fit is ~100,000 launches
        "gf::track": lambda: FT.fit_sequence(man["lms"], lb, DATAGEN_HW, DATAGEN_HW,
                                             coarse_steps=30, refine_steps=70),
        "gf::photo": step,
    }
    span_ms = {}
    for name, run in windows.items():
        span_ms[name] = kernel_table(profiled(run, acts))[1].get(name)
    print(f"{path}: photometric step wall {wall:.3f} ms, device busy {fmt_ms(busy, ' ms')} (idle "
          f"share {fmt_ms(idle)}); spans ms (one frame of parse and FAN, 32 crops of recon, "
          "a landmark fit of 30 + 70 steps, one photometric step) "
          + json.dumps({k: None if v is None else round(v, 3) for k, v in span_ms.items()}))
    return {"photo_step_wall_ms": wall, "device_busy_ms": busy, "idle_share": idle,
            "spans_ms": span_ms, "top_kernels": [[k[0][:100], k[1], k[2]] for k in kernels[:12]]}


#: the vanilla NeRF cells: the shipped configs at their base widths (hidden
#: 256, cond 64, 64 + 128 samples, 1,600 rays a step); frames rendered per
#: video and their seeded lm3d; head and torso steps (the attention from
#: head step 3 on); the card-vs-CPU cuts
NERF_YAML = "egs/egs_bases/nerf/lm3d_nerf.yaml"
NERF_TORSO_YAML = "egs/egs_bases/nerf/lm3d_nerf_torso.yaml"
NERF_FRAMES = 2
NERF_HEAD_STEPS = 8
NERF_NO_SMO = 3
NERF_TORSO_STEPS = 6
NERF_CHECK_RAYS = 1024
NERF_STEP_CHECK_RAYS = 256
#: card vs CPU bounds: a chunk's pixels (max abs, the CPU on the card's fine
#: samples), a step's loss (relative) and each gradient leaf (relative L2;
#: the CPU on the card's samples and ReLU decisions)
NERF_FRAME_BOUND = 1e-3
NERF_LOSS_BOUND = 1e-5
NERF_GRAD_BOUND = 1e-3


def nerf_cfg(cfg: dict, torso: bool = False) -> dict:
    """A vanilla NeRF cell: the shipped base config (``lm3d_nerf.yaml``, or
    ``lm3d_nerf_torso.yaml`` on the head's work dir) on the scene's data,
    its seeded checkpoint's work dir."""
    from geneface_tpu_torch.config.config import load_config

    root = os.path.dirname(cfg["work_dir"])
    out = dict(load_config(os.path.join(REPO, NERF_TORSO_YAML if torso else NERF_YAML)))
    out.update(data_dir=cfg["data_dir"], work_dir=os.path.join(root, "nerf_head"), seed=0,
               infer_lm3d_clamp_std=2.5, infer_inject_eye_blink_mode="gt",
               infer_lm3d_smooth_sigma=1.0)
    if torso:
        out.update(work_dir=os.path.join(root, "nerf_torso"), head_model_dir=out["work_dir"])
    return out


def write_nerf_checkpoints(cfg: dict) -> None:
    """Seeded ``Lm3dNeRF`` head and ``ADNeRFTorso`` torso at the configs'
    widths as JAX-layout checkpoints; the sigma biases at 3 keep the fields
    translucent (at the bare init ReLU cuts most sigmas to 0)."""
    import torch

    from geneface_tpu_torch.convert import nerf_state_dict_to_flax
    from geneface_tpu_torch.tasks.lm3d_nerf import Lm3dNeRFTorsoTask
    from geneface_tpu_torch.utils.checkpoint import save_checkpoint

    tcfg = nerf_cfg(cfg, torso=True)
    task = Lm3dNeRFTorsoTask(tcfg, device="cpu")
    for i, (model, work) in enumerate(((task.make_model(), tcfg["head_model_dir"]),
                                       (task.make_torso_model(), tcfg["work_dir"]))):
        model.reset_parameters(torch.Generator().manual_seed(10 + i))
        with torch.no_grad():
            for net in (model.model_coarse, model.model_fine):
                net.layers[net.num_density_linears].bias.fill_(3.0)
        save_checkpoint(os.path.join(work, "model_ckpt_steps_0.ckpt"),
                        {"state": {"params": nerf_state_dict_to_flax(model.state_dict())},
                         "step": 0})


def nerf_profile(run, out_dir: str, name: str, wall_ms: float) -> dict:
    """Device time of ``run()`` by kernel, its launches and the ``gf::``
    spans (the vanilla NeRF's backbone products, ``freq_encode``, the
    composite, ``sample_pdf`` with its sort; the ASR and audio2pose spans),
    from ``torch.profiler``; the table goes to
    ``out_dir/<name>_profile.txt``."""
    from torch.profiler import ProfilerActivity

    kernels, stages, busy = kernel_table(
        profiled(run, [ProfilerActivity.CPU, ProfilerActivity.CUDA]))
    with open(os.path.join(out_dir, f"{name}_profile.txt"), "w") as f:
        f.write(f"wall {wall_ms:.3f} ms, device busy {fmt_ms(busy, ' ms')}\n")
        for stage, ms in sorted(stages.items(), key=lambda s: -s[1]):
            f.write(f"stage {stage:24s} {ms:9.3f} ms\n")
        for kname, ms, n in kernels:
            f.write(f"{ms:9.3f} ms {n:5d}x {kname}\n")
    gemm = sum(ms for k, ms, _ in kernels if "gemm" in k.lower() or "sgemm" in k.lower())
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": None if busy is None else max(0.0, 1.0 - busy / wall_ms),
            "stages_ms": stages, "gemm_kernels_ms": gemm if kernels else None,
            "launches": sum(k[2] for k in kernels) if kernels else None,
            "top_kernels": [[k[0][:100], k[1], k[2]] for k in kernels[:12]]}


def nerf_chunk_vs_cpu(infer, conds, path: str, name: str) -> float:
    """A ``NERF_CHECK_RAYS`` chunk through the face of frame 0 on the card,
    then on the port's CPU path fed the card's fine samples."""
    import torch

    from geneface_tpu_torch.inference.nerf_infer import LM3dNeRFInfer

    x = infer.frame_inputs(0, conds)
    N = x["bg"].shape[0]
    sl = slice(N // 2 - NERF_CHECK_RAYS // 2, N // 2 + NERF_CHECK_RAYS // 2)
    with torch.no_grad():
        args = [x[k] for k in ("cond_wins", "euler", "trans")]
        feat = infer.model.cal_cond_feat(x["cond_wins"], True)
        card, zs = infer.render_chunk([a[sl] for a in x["rays"]], x["bg"][sl], feat, *args)
        cpu = LM3dNeRFInfer(infer.cfg, device="cpu")
        cargs = [a.cpu() for a in args]
        cfeat = cpu.model.cal_cond_feat(cargs[0], True)
        ref, _ = cpu.render_chunk([a[sl].cpu() for a in x["rays"]], x["bg"][sl].cpu(), cfeat,
                                  *cargs, z_samples=tuple(None if z is None else z.cpu()
                                                          for z in zs))
    return held(f"{name} chunk of {NERF_CHECK_RAYS} rays", card, ref, NERF_FRAME_BOUND,
                relative=False, path=path)


def nerf_serve_phase(cfg, out_dir: str, path: str = "nerf_serve") -> tuple:
    """The vanilla renderer serving: ``LM3dNeRFInfer.run`` of a seeded
    predicted lm3d through the clean-up (clamp, ground-truth blinks,
    smoothing) to ``NERF_FRAMES`` 512² head frames with their mp4, then the
    same through the head+torso; steady ms/frame, the profile by stage, and
    a chunk of each held against the CPU → (record, launches, sites)."""
    import numpy as np
    import torch

    from geneface_tpu_torch.inference.nerf_infer import LM3dNeRFInfer
    from geneface_tpu_torch.kernels import LAUNCHES

    write_nerf_checkpoints(cfg)
    torch.cuda.reset_peak_memory_stats()
    npy = os.path.join(os.path.dirname(cfg["work_dir"]), "nerf_pred_lm3d.npy")
    ds = np.load(os.path.join(cfg["data_dir"], "trainval_dataset.npy"), allow_pickle=True).item()
    np.save(npy, (ds["idexp_lm3d_mean"][None] + 0.5 * ds["idexp_lm3d_std"][None]
                  * np.random.RandomState(5).randn(NERF_FRAMES, 68, 3)).reshape(1, -1, 204))
    record, launches = {}, {k: 0 for k in LAUNCHES}
    for name, torso in (("head", False), ("head_torso", True)):
        clock = [time.perf_counter()]
        infer = LM3dNeRFInfer(nerf_cfg(cfg, torso))
        out = os.path.join(out_dir, f"{path}_{name}.mp4")
        # each frame of the run timed (its pixels come back to the host at
        # its end); the second one is warm: the steady time
        times, frames, render = [], [], infer.render_frame

        def timed(i, conds):
            ts = time.perf_counter()
            frames.append(render(i, conds))
            times.append((time.perf_counter() - ts) * 1e3)
            return frames[-1]

        infer.render_frame = timed
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        infer.run(npy, out)
        torch.cuda.synchronize()
        video_ms = (time.perf_counter() - t1) * 1e3 / NERF_FRAMES
        infer.render_frame = render
        for k in LAUNCHES:
            launches[k] += LAUNCHES[k]
        if not os.path.getsize(out) or len(times) != NERF_FRAMES:
            raise AssertionError(f"{path}: {out} is empty, or {len(times)} frames")
        clock.append(time.perf_counter())
        conds = infer.get_conds(np.load(npy).reshape(-1, 68, 3))
        steady, frame = times[-1], frames[0]
        bg = infer.dataset[0]["bg_img"].reshape(frame.shape)
        shown = float(np.abs(frame - bg).max())
        if frame.shape != (HW, HW, 3) or not np.isfinite(frame).all() or shown < 0.02:
            raise AssertionError(f"{path} {name}: frame {frame.shape}, shows {shown}")
        prof = nerf_profile(lambda: infer.render_frame(0, conds), out_dir,
                            f"{path}_frame" if not torso else f"{path}_torso_frame", steady)
        clock.append(time.perf_counter())
        err = nerf_chunk_vs_cpu(infer, conds, path, name)
        clock.append(time.perf_counter())
        parts = dict(zip(("set-up and run", "profile", "cpu check"),
                         (round(b - a, 1) for a, b in zip(clock, clock[1:]))))
        rays = HW * HW
        samples = rays * (infer.render_kwargs["n_samples"] * 2
                          + infer.render_kwargs["n_importance"]) * (2 if torso else 1)
        print(f"{path} {name}: ms/frame video {video_ms:.3f} (run of {NERF_FRAMES} frames, "
              f"conditions and mp4 included), frames ms {[round(t, 3) for t in times]}, "
              f"steady (the last) {steady:.3f} ms "
              f"({rays / steady * 1e3:.0f} rays/s, {samples / steady * 1e3:.4g} field samples/s)"
              f"; device busy {fmt_ms(prof['device_busy_ms'], ' ms')}, idle share "
              f"{fmt_ms(prof['idle_share'])}; GEMM kernels {fmt_ms(prof['gemm_kernels_ms'], ' ms')}"
              "; stages ms " + json.dumps({k: round(v, 3) for k, v in prof["stages_ms"].items()})
              + "; phase seconds " + json.dumps(parts))
        record[name] = {"ms_per_frame_video": video_ms, "frames_ms": times, "steady_ms": steady,
                        "profile": prof,
                        "phase_seconds": parts,
                        "chunk_vs_cpu_max_abs": err, "shows_max_abs": shown,
                        "field_samples": samples}
    if any(launches.values()):
        raise AssertionError(f"{path}: the vanilla renderer launched {launches}")
    record["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"{path}: launches {json.dumps(launches)} (the vanilla path runs neither kernel); "
          f"peak device memory {record['peak_memory_gb']:.3f} GB")
    return record, launches, {}


def nerf_step_vs_cpu(task, batch, path: str, name: str) -> dict:
    """One step's loss and gradients on the first ``NERF_STEP_CHECK_RAYS``
    rays of ``batch``: the card, then the port's CPU path on the same
    parameters, draws, fine samples and ReLU decisions."""
    import numpy as np
    import torch

    from geneface_tpu_torch.models.nerf import backbone, models
    from geneface_tpu_torch.models.radnerf import cond_encoder
    from geneface_tpu_torch.ops import volume
    from geneface_tpu_torch.tasks import lm3d_nerf

    n = NERF_STEP_CHECK_RAYS
    cut = {k: (v[:n] if k.startswith(("rays", "gt_img", "bg_img")) else v)
           for k, v in batch.items()}
    noise = task.draw_noise(n)
    cpu = type(task)(task.cfg, device="cpu")
    cpu.build()
    cpu.trainable().load_state_dict(task.trainable().state_dict())
    if cpu.model is not cpu.trainable():
        cpu.model.load_state_dict(task.model.state_dict())
    decisions = CardDecisions((backbone, models, cond_encoder))
    samples = []

    def card_render(*args, **kw):
        out = volume.render_rays(*args, **kw)
        samples.append(out["z_samples"].cpu())
        return out

    def cpu_render(*args, **kw):
        return volume.render_rays(*args, z_samples=samples.pop(0), **kw)

    out = []
    for t, dev_noise, render, ctx in ((task, noise, card_render, decisions.record),
                                      (cpu, {k: v.cpu() for k, v in noise.items()}, cpu_render,
                                       decisions.replay)):
        lm3d_nerf.render_rays = render
        try:
            with ctx():
                t.optimizer.zero_grad(set_to_none=True)
                loss, _ = t.loss_fn(t.device_batch(cut), dev_noise, task.with_att())
                loss.backward()
        finally:
            lm3d_nerf.render_rays = volume.render_rays
        out.append((float(loss.detach()), {k: p.grad.detach().cpu().double()
                                  for k, p in t.trainable().named_parameters()
                                  if p.grad is not None}))
    task.optimizer.zero_grad(set_to_none=True)
    (lc, gc), (lp, gp) = out
    loss_rel = abs(lc - lp) / abs(lp)
    if set(gc) != set(gp):
        raise AssertionError(f"{path} {name}: gradients of {sorted(set(gc) ^ set(gp))}")
    rel = {k: float(torch.linalg.norm(gc[k] - gp[k]) / torch.linalg.norm(gp[k]).clamp_min(1e-30))
           for k in gp}
    worst = max(rel, key=rel.get)
    print(f"{path} {name}: step on {n} rays card vs CPU: loss rel {loss_rel:.3e} (bound "
          f"{NERF_LOSS_BOUND:g}); gradients relative L2 max {rel[worst]:.3e} at {worst} "
          f"(bound {NERF_GRAD_BOUND:g}) over {len(rel)} tensors; ReLU decisions replayed: "
          f"{decisions.flips} of {decisions.elements} differed on the CPU")
    if not (loss_rel <= NERF_LOSS_BOUND and rel[worst] <= NERF_GRAD_BOUND):
        raise AssertionError(f"{path} {name}: card step disagrees with the CPU")
    return {"loss_rel": loss_rel, "grad_rel_l2_max": rel[worst], "grad_rel_l2_at": worst,
            "relu_flips": decisions.flips, "relu_elements": decisions.elements,
            "grad_rel_l2_median": float(np.median(list(rel.values())))}


def nerf_steps(task, n_steps: int, out_dir: str, path: str, name: str) -> dict:
    """``n_steps`` of ``train_step`` on the task's batches: ms/step (host
    clock to a synchronize), the losses, the attention switch; then one
    step profiled and one step held against the CPU."""
    import numpy as np
    import torch

    batches = task.train_batches(0)
    times, losses, att = [], [], []
    for _ in range(n_steps):
        batch = next(batches)
        att.append(task.with_att())
        torch.cuda.synchronize()
        ts = time.perf_counter()
        step = task.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - ts) * 1e3)
        losses.append({k: float(v) for k, v in step.items()})
        groups = {g["name"]: any(p.grad is not None and bool(p.grad.abs().sum() > 0)
                                 for p in g["params"]) for g in task.optimizer.param_groups}
        if not all(np.isfinite(list(losses[-1].values()))):
            raise AssertionError(f"{path} {name}: non-finite losses {losses[-1]}")
        if not groups["net"] or groups.get("att", False) != att[-1]:
            raise AssertionError(f"{path} {name}: gradients by group {groups}, attention "
                                 f"{att[-1]}")
    median = float(np.median(times[2:]))
    batch = next(batches)
    prof = nerf_profile(lambda: task.train_step(batch), out_dir, f"{path}_{name}_step", median)
    check = nerf_step_vs_cpu(task, next(batches), path, name)
    rays = int(task.cfg["n_rays"])
    print(f"{path} {name}: median ms/step {median:.3f} over steps 2-{n_steps - 1} "
          f"({rays / median * 1e3:.0f} rays/s); steps ms {[round(t, 3) for t in times]}; "
          f"attention by step {att}; device busy {fmt_ms(prof['device_busy_ms'], ' ms')}, "
          f"idle share {fmt_ms(prof['idle_share'])}; first and last losses "
          f"{json.dumps(losses[0])} {json.dumps(losses[-1])}")
    return {"ms_per_step": median, "steps_ms": times, "rays_per_s": rays / median * 1e3,
            "attention": att, "losses": [losses[0], losses[-1]], "profile": prof,
            "step_vs_cpu": check}


def nerf_train_phase(cfg, out_dir: str, path: str = "nerf_train") -> tuple:
    """Vanilla NeRF training: ``Lm3dNeRFTask`` steps at 1,600 rays (the
    warm start to step ``NERF_NO_SMO``, then the attention), its checkpoint
    as the torso's head, ``Lm3dNeRFTorsoTask`` steps on it with the head
    bit-identical afterwards → (record, launches, sites)."""
    import torch

    from geneface_tpu_torch.kernels import LAUNCHES
    from geneface_tpu_torch.tasks.lm3d_nerf import Lm3dNeRFTask, Lm3dNeRFTorsoTask
    from geneface_tpu_torch.utils.checkpoint import save_checkpoint

    root = os.path.dirname(cfg["work_dir"])
    head_cfg = dict(nerf_cfg(cfg), work_dir=os.path.join(root, "nerf_train_head"),
                    no_smo_iterations=NERF_NO_SMO)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    head = Lm3dNeRFTask(head_cfg)
    head.build()
    record = {"head": nerf_steps(head, NERF_HEAD_STEPS, out_dir, path, "head")}
    save_checkpoint(os.path.join(head_cfg["work_dir"], f"model_ckpt_steps_{head._step}.ckpt"),
                    head.checkpoint_payload(head._step))
    torso_cfg = dict(nerf_cfg(cfg, torso=True), work_dir=os.path.join(root, "nerf_train_torso"),
                     head_model_dir=head_cfg["work_dir"])
    torso = Lm3dNeRFTorsoTask(torso_cfg)
    torso.build()
    frozen = {k: v.clone() for k, v in torso.model.state_dict().items()}
    for k, v in head.model.state_dict().items():
        if not torch.equal(frozen[k], v):
            raise AssertionError(f"{path}: the torso's head differs from the trained head at {k}")
    record["torso"] = nerf_steps(torso, NERF_TORSO_STEPS, out_dir, path, "torso")
    for k, v in torso.model.state_dict().items():
        if not torch.equal(frozen[k], v):
            raise AssertionError(f"{path}: the frozen head moved at {k}")
    launches = dict(LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"{path}: the vanilla tasks launched {launches}")
    record["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"{path}: launches {json.dumps(launches)} (the vanilla path runs neither kernel); "
          "the frozen head bit-identical after the torso steps; peak device memory "
          f"{record['peak_memory_gb']:.3f} GB")
    return record, launches, {}


#: the asr path: the shipped DeepSpeech v0.1.0 widths (494 → 2048 → 2048 →
#: 2048, an LSTM cell of 2048, 2048 → 29), authored as a GraphDef ``.pb``;
#: the esperanto wav2vec2 at ``Wav2Vec2Config``'s defaults (xlsr-large, 24 ×
#: 1024, vocab 44); the video's ADNeRF head at ``adnerf.yaml``'s widths
ADNERF_YAML = "egs/egs_bases/nerf/adnerf.yaml"
DS_WIDTHS = (494, 2048, 2048, 29)
ASR_FRAMES = 200  # 8 s at 25 fps
ASR_VIDEO_FRAMES = 2
#: card vs CPU bounds, relative to max |CPU|: the DeepSpeech logits (an
#: LSTM over 400 frames carries the products' other summation order), the
#: wav2vec2 logits (24 layers, as HuBERT-large's 1e-5 in audio_serve)
DS_BOUND = 1e-5
W2V_BOUND = 1e-5


def _pb_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _pb_field(field: int, payload: bytes) -> bytes:
    """A length-delimited protobuf field."""
    return _pb_varint((field << 3) | 2) + _pb_varint(len(payload)) + payload


def write_graph_pb(path: str, consts: list) -> int:
    """A GraphDef of ``Const`` nodes ``[(name, float32 array), ...]``, in the
    protobuf wire format a frozen TF graph has (NodeDef ``name``/``op``/
    ``attr["value"]`` → TensorProto dtype 1, shape, ``tensor_content``),
    plus the input placeholder → bytes written."""
    with open(path, "wb") as f:
        n = f.write(_pb_field(1, _pb_field(1, b"input_node") + _pb_field(2, b"Placeholder")))
        for name, arr in consts:
            shape = b"".join(_pb_field(2, _pb_varint(1 << 3) + _pb_varint(int(s)))
                             for s in arr.shape)
            tensor = (_pb_varint(1 << 3) + _pb_varint(1) + _pb_field(2, shape)
                      + _pb_field(4, arr.astype("<f4").tobytes()))
            attr = _pb_field(1, b"value") + _pb_field(2, _pb_field(8, tensor))
            node = _pb_field(1, name.encode()) + _pb_field(2, b"Const") + _pb_field(5, attr)
            n += f.write(_pb_field(1, node))
    return n


def write_deepspeech_pb(path: str, seed: int = 0) -> dict:
    """DeepSpeech v0.1.0 at full width from a seeded generator, under
    Mozilla's names (``h1``/``b1`` … ``h6``/``b6``, the LSTM's kernel and
    bias), weights uniform in ±1/sqrt(fan_in) → the param dict."""
    import numpy as np
    import torch

    n_in, hid, cell, n_cls = DS_WIDTHS
    gen = torch.Generator().manual_seed(seed)
    shapes = {"h1": (n_in, hid), "h2": (hid, hid), "h3": (hid, hid),
              "lstm_kernel": (hid + cell, 4 * cell), "h5": (cell, hid), "h6": (hid, n_cls)}
    params = {}
    for k, (fan_in, fan_out) in shapes.items():
        bound = 1.0 / np.sqrt(fan_in)
        bias = "lstm_bias" if k == "lstm_kernel" else "b" + k[1]
        params[k] = ((torch.rand(fan_in, fan_out, generator=gen) * 2 - 1) * bound).numpy()
        params[bias] = ((torch.rand(fan_out, generator=gen) * 2 - 1) * bound).numpy()
    order = ("h1", "b1", "h2", "b2", "h3", "b3", "lstm_kernel", "lstm_bias", "h5", "b5",
             "h6", "b6")
    names = {"lstm_kernel": "lstm/basic_lstm_cell/kernel", "lstm_bias": "lstm/basic_lstm_cell/bias"}
    write_graph_pb(path, [(names.get(k, k), params[k]) for k in order])
    return params


def adnerf_cfg(cfg: dict) -> dict:
    """The ADNeRF head of ``adnerf.yaml`` on the scene's data, its seeded
    checkpoint's work dir."""
    from geneface_tpu_torch.config.config import load_config

    out = dict(load_config(os.path.join(REPO, ADNERF_YAML)))
    out.update(data_dir=cfg["data_dir"], seed=0,
               work_dir=os.path.join(os.path.dirname(cfg["work_dir"]), "adnerf_head"))
    return out


def write_adnerf_checkpoint(acfg: dict) -> None:
    """A seeded ``ADNeRF`` head at the config's widths, sigma biases at 3
    (a translucent field), as a JAX-layout checkpoint."""
    import torch

    from geneface_tpu_torch.convert import nerf_state_dict_to_flax
    from geneface_tpu_torch.tasks.lm3d_nerf import ADNeRFTask
    from geneface_tpu_torch.utils.checkpoint import save_checkpoint

    model = ADNeRFTask(acfg, device="cpu").make_model()
    model.reset_parameters(torch.Generator().manual_seed(12))
    with torch.no_grad():
        for net in (model.model_coarse, model.model_fine):
            net.layers[net.num_density_linears].bias.fill_(3.0)
    save_checkpoint(os.path.join(acfg["work_dir"], "model_ckpt_steps_0.ckpt"),
                    {"state": {"params": nerf_state_dict_to_flax(model.state_dict())},
                     "step": 0})


def asr_phase(cfg, out_dir: str, path: str = "asr") -> tuple:
    """The ASR conditions from a wav: the MFCC rows (host), DeepSpeech v0.1.0
    at full width from an authored ``.pb`` (``extract_deepspeech_features``
    → ``[200, 16, 29]``), the esperanto wav2vec2 at xlsr-large's widths
    (``extract_esperanto_features`` → ``[200, 16, 44]``) and
    ``StreamingASR`` on the same wav (context 12, strides 4/4); each held
    against the port's CPU path; then the DeepSpeech windows as a ``.npy``
    drive ``ADNeRFInfer.run`` to 2 frames at 512² with the mp4 →
    (record, launches, sites)."""
    import dataclasses

    import numpy as np
    import torch

    from geneface_tpu_torch.convert import flax_variables
    from geneface_tpu_torch.datagen._ds_audio import audio_to_mfcc_windows
    from geneface_tpu_torch.datagen.asr_features import (
        extract_deepspeech_features,
        extract_esperanto_features,
        load_esperanto,
    )
    from geneface_tpu_torch.datagen.deepspeech import load_deepspeech
    from geneface_tpu_torch.datagen.streaming_asr import StreamingASR
    from geneface_tpu_torch.datagen.wav2vec2 import Wav2Vec2Config, Wav2Vec2CTC
    from geneface_tpu_torch.inference.nerf_infer import ADNeRFInfer
    from geneface_tpu_torch.kernels import LAUNCHES
    from geneface_tpu_torch.models.layers import init_weights_
    from geneface_tpu_torch.utils.audio import load_wav16k
    from geneface_tpu_torch.utils.checkpoint import save_checkpoint

    root = os.path.join(os.path.dirname(cfg["work_dir"]), "asr")
    os.makedirs(root, exist_ok=True)
    clock = [time.perf_counter()]
    wav_path, pb = os.path.join(root, "speech.wav"), os.path.join(root, "output_graph.pb")
    write_voiced_wav(wav_path, AUDIO_SECONDS)
    write_deepspeech_pb(pb)
    w2v_cfg = Wav2Vec2Config()  # xlsr-large, vocab 44
    w2v_cpu = init_weights_(Wav2Vec2CTC(w2v_cfg), torch.Generator().manual_seed(5)).eval()
    ckpt = os.path.join(root, "esperanto.pkl")
    save_checkpoint(ckpt, {"config": dataclasses.asdict(w2v_cfg),
                           "params": flax_variables(w2v_cpu)})
    clock.append(time.perf_counter())
    print(f"{path}: wav, DeepSpeech .pb ({os.path.getsize(pb) / 2**20:.1f} MiB) and esperanto "
          f"checkpoint ({os.path.getsize(ckpt) / 2**20:.0f} MiB) written in "
          f"{clock[-1] - clock[-2]:.1f} s")

    for k in LAUNCHES:
        LAUNCHES[k] = 0
    wav = load_wav16k(wav_path)
    # DeepSpeech: the MFCC rows on the host, the net on the card
    mfcc_ms = host_ms(lambda: audio_to_mfcc_windows(wav), n=3)
    feats, n_rows = audio_to_mfcc_windows(wav)
    t0 = time.perf_counter()
    net = load_deepspeech(pb, "cuda")
    load_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds_wins = extract_deepspeech_features(wav, n_frames=ASR_FRAMES, net=net)
    torch.cuda.synchronize()
    extract_ms = (time.perf_counter() - t0) * 1e3
    if ds_wins.shape != (ASR_FRAMES, 16, 29) or not np.isfinite(ds_wins).all():
        raise AssertionError(f"{path}: DeepSpeech windows {ds_wins.shape}")
    x = torch.from_numpy(feats).cuda()

    def ds_forward():
        with torch.inference_mode():
            net(x)

    ds_wall = host_ms(ds_forward, n=3)
    ds_prof = nerf_profile(ds_forward, out_dir, f"{path}_deepspeech", ds_wall)
    n_in, hid, cell, n_cls = DS_WIDTHS
    lstm_bytes = (hid + cell) * 4 * cell * 4
    lstm_bound = lstm_bytes * n_rows / PEAK_BYTES_S * 1e3
    dense_bytes = 4 * (n_in * hid + 2 * hid * hid + cell * hid + hid * n_cls)
    forward_bound = lstm_bound + dense_bytes / PEAK_BYTES_S * 1e3
    with torch.inference_mode():
        card = net(x).cpu().numpy()
        net_cpu = load_deepspeech(pb, "cpu")
        ref = net_cpu(torch.from_numpy(feats)).numpy()
    errs = {"deepspeech_logits": held("DeepSpeech logits (400 LSTM steps)", card, ref,
                                      DS_BOUND, path=path)}
    ref_wins = extract_deepspeech_features(wav, n_frames=ASR_FRAMES, net=net_cpu)
    errs["deepspeech_windows"] = held("deepspeech_win", ds_wins, ref_wins, DS_BOUND, path=path)
    del net_cpu
    lstm_span = ds_prof["stages_ms"].get("gf::deepspeech_lstm")
    print(f"{path}: {CARD}: DeepSpeech at {DS_WIDTHS}: {len(wav)} samples → {n_rows} MFCC rows "
          f"(host {mfcc_ms:.3f} ms) → logits {card.shape} → windows {ds_wins.shape}; graph "
          f"read {load_ms:.1f} ms; extract {extract_ms:.3f} ms wall; forward {ds_wall:.3f} ms "
          f"wall, device busy {fmt_ms(ds_prof['device_busy_ms'], ' ms')}, idle share "
          f"{fmt_ms(ds_prof['idle_share'])}, {ds_prof['launches']} launches; spans ms "
          + json.dumps({k: round(v, 3) for k, v in ds_prof["stages_ms"].items()})
          + f"; LSTM bound {lstm_bound:.3f} ms ({lstm_bytes / 1e6:.1f} MB kernel read once per "
          f"step × {n_rows} steps at {PEAK_BYTES_S / 1e12:.2f} TB/s), forward bound "
          f"{forward_bound:.3f} ms (bytes); LSTM span / bound "
          f"{fmt_ms(None if lstm_span is None else lstm_span / lstm_bound)}")

    # esperanto: the checkpoint read onto the card; the CPU check on the
    # model that wrote it
    t0 = time.perf_counter()
    w2v = load_esperanto(ckpt, "cuda")
    w2v_load_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eo_wins = extract_esperanto_features(wav, n_frames=ASR_FRAMES, model=w2v)
    torch.cuda.synchronize()
    eo_ms = (time.perf_counter() - t0) * 1e3
    if eo_wins.shape != (ASR_FRAMES, 16, 44) or not np.isfinite(eo_wins).all():
        raise AssertionError(f"{path}: esperanto windows {eo_wins.shape}")
    eo_ref = extract_esperanto_features(wav, n_frames=ASR_FRAMES, model=w2v_cpu)
    errs["esperanto_windows"] = held("esperanto_win", eo_wins, eo_ref, W2V_BOUND, path=path)
    eo_wall = host_ms(lambda: extract_esperanto_features(wav, model=w2v), n=3)
    eo_prof = nerf_profile(lambda: extract_esperanto_features(wav, model=w2v), out_dir,
                           f"{path}_esperanto", eo_wall)
    print(f"{path}: esperanto wav2vec2 (xlsr-large widths, vocab 44): checkpoint read "
          f"{w2v_load_ms:.1f} ms; extract {eo_ms:.3f} ms first, {eo_wall:.3f} ms warm, device "
          f"busy {fmt_ms(eo_prof['device_busy_ms'], ' ms')}, idle share "
          f"{fmt_ms(eo_prof['idle_share'])}")

    # streaming: the same wav through the card's model and the CPU's; the
    # windows of run() and the get_next_feat sequence of the same stream
    def stream(model):
        asr = StreamingASR(wav_path, model=model, save_feats=True)
        seg_ms, feats_seq, forward = [], [], asr._forward

        def timed(seg):
            ts = time.perf_counter()
            out = forward(seg)
            seg_ms.append((time.perf_counter() - ts) * 1e3)
            return out

        asr._forward = timed
        n_seg = 0
        while asr.run_step():
            if len(seg_ms) > n_seg:  # a segment came in: one video frame's window stack
                n_seg = len(seg_ms)
                feats_seq.append(asr.get_next_feat())
        return asr.run(), np.stack(feats_seq), seg_ms

    st_wins, st_feats, seg_ms = stream(w2v)
    st_ref, st_feats_ref, _ = stream(w2v_cpu)
    errs["streaming_windows"] = held("streaming windows", st_wins, st_ref, W2V_BOUND, path=path)
    errs["streaming_next_feat"] = held("get_next_feat sequence", st_feats, st_feats_ref,
                                       W2V_BOUND, path=path)
    del w2v_cpu
    if st_wins.shape[1:] != (16, 44) or st_feats.shape[1:] != (8, 44, 16):
        raise AssertionError(f"{path}: streaming {st_wins.shape}, {st_feats.shape}")
    seg_steady = float(np.median(seg_ms[1:-1])) if len(seg_ms) > 2 else seg_ms[-1]
    print(f"{path}: StreamingASR (context 12, strides 4/4): {len(seg_ms)} segments (the last "
          f"the flush), ms per segment forward median {seg_steady:.3f} (first {seg_ms[0]:.3f}, "
          f"flush {seg_ms[-1]:.3f}), windows {st_wins.shape}, {len(st_feats)} get_next_feat "
          f"stacks")

    # the DeepSpeech family's wav-to-video path
    acfg = adnerf_cfg(cfg)
    write_adnerf_checkpoint(acfg)
    npy = os.path.join(root, "deepspeech_win.npy")
    np.save(npy, ds_wins)
    infer = ADNeRFInfer(acfg)
    mp4 = os.path.join(out_dir, f"{path}_adnerf.mp4")
    frames, render = [], infer.render_frame
    infer.render_frame = lambda i, conds: frames.append(render(i, conds)) or frames[-1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    infer.run(npy, mp4, n_frames=ASR_VIDEO_FRAMES)
    torch.cuda.synchronize()
    video_ms = (time.perf_counter() - t0) * 1e3 / ASR_VIDEO_FRAMES
    frame = frames[-1]
    bg = infer.dataset[len(frames) - 1]["bg_img"].reshape(frame.shape)
    shown = float(np.abs(frame - bg).max())
    if not os.path.getsize(mp4) or frame.shape != (HW, HW, 3) or not np.isfinite(
            frame).all() or shown < 0.02:
        raise AssertionError(f"{path}: ADNeRF frame {frame.shape}, shows {shown}")
    launches = dict(LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"{path}: the ASR path launched {launches}")
    clock.append(time.perf_counter())
    print(f"{path}: ADNeRF ({ADNERF_YAML}) from the DeepSpeech windows: {ASR_VIDEO_FRAMES} "
          f"frames at {HW}² with the mp4, ms/frame {video_ms:.3f}; launches "
          f"{json.dumps(launches)} (the ASR path runs neither kernel)")
    record = {"audio_seconds": AUDIO_SECONDS, "mfcc_rows": n_rows, "mfcc_host_ms": mfcc_ms,
              "deepspeech": {"widths": DS_WIDTHS, "graph_read_ms": load_ms,
                             "extract_ms": extract_ms, "profile": ds_prof,
                             "lstm_bound_ms": lstm_bound, "forward_bound_ms": forward_bound},
              "esperanto": {"checkpoint_read_ms": w2v_load_ms, "extract_first_ms": eo_ms,
                            "profile": eo_prof},
              "streaming": {"segments": len(seg_ms), "segment_ms": seg_ms,
                            "segment_ms_median": seg_steady},
              "adnerf_ms_per_frame_video": video_ms, "card_vs_cpu_max_abs": errs,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    return record, launches, {}


#: the pose path: a synthetic store at talking-head clip lengths (10–16 s
#: at 25 fps), ``egs/datasets/videos/May/audio2pose.yaml``'s keys
POSE_YAML = "egs/datasets/videos/May/audio2pose.yaml"
POSE_CLIPS = (16, 4)
POSE_FRAMES = (250, 400)
POSE_STEPS = 8
POSE_PROFILE_FRAMES = 25
POSE_LOSS_BOUND = 1e-5
POSE_GRAD_BOUND = 1e-4
#: the rollout's poses card vs CPU, relative to max |CPU|: 200 frames, each
#: feeding its sample back into the history
POSE_ROLLOUT_BOUND = 1e-4


def write_pose_store(root: str, seed: int = 0) -> str:
    """``train``/``val`` clips of ``audio [T, 58]`` (the DeepSpeech centre
    columns' width) and ``pose [T, 6]`` written with ``IndexedDatasetBuilder``, and
    ``stats.npz`` (``mean_trans``, ``init_pose``) → the store's dir."""
    import numpy as np

    from geneface_tpu_torch.utils.indexed_dataset import IndexedDatasetBuilder

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for prefix, n in zip(("train", "val"), POSE_CLIPS):
        b = IndexedDatasetBuilder(os.path.join(root, prefix))
        for i in range(n):
            T = rng.randint(*POSE_FRAMES)
            t = np.arange(T)
            audio = (np.sin(0.2 * t)[:, None] * rng.randn(1, 58)
                     + rng.randn(T, 58) * 0.5).astype(np.float32)
            pose = np.stack([0.1 * np.sin(0.05 * t + k) + 0.02 * np.sin(0.31 * t * (k + 1))
                             for k in range(6)], -1).astype(np.float32)
            b.add_item({"audio": audio, "pose": pose}, id=i)
        b.finalize()
    np.savez(os.path.join(root, "stats.npz"), mean_trans=np.array([0.0, 0.0, -4.0], np.float32),
             init_pose=np.array([0.02, -0.01, 0.0, 0.01, 0.0, 0.0], np.float32))
    return root


def feeds_nothing(model) -> set:
    """The parameters of the WaveNet's last residual conv: its output feeds
    no later block, so they get no gradient (zeros in JAX)."""
    return {f"backbone.block_{model.backbone.n_blocks - 1}.res.{a}" for a in ("weight", "bias")}


def pose_step_vs_cpu(task, batch, path: str) -> dict:
    """One step's loss and gradients on ``batch``: the card, then a CPU task
    with the card task's parameters, the card's LeakyReLU decisions
    replayed; every parameter but the last block's residual conv (it feeds
    nothing) has a non-zero gradient."""
    import numpy as np
    import torch

    from geneface_tpu_torch.models.audio2pose import models as a2p_models

    cpu = type(task)(task.cfg, device="cpu")
    cpu.build()
    cpu.model.load_state_dict(task.model.state_dict())
    decisions = CardDecisions((a2p_models,))
    out = []
    for t, ctx in ((task, decisions.record), (cpu, decisions.replay)):
        with ctx():
            t.model.zero_grad(set_to_none=True)
            loss, _ = t.loss_fn(t.to_device(batch))
            loss.backward()
        out.append((float(loss.detach()), {n: p.grad.detach().cpu().double()
                                           for n, p in t.model.named_parameters()
                                           if p.grad is not None}))
    task.model.zero_grad(set_to_none=True)
    (lc, gc), (lp, gp) = out
    dead = {n for n, _ in task.model.named_parameters()} - set(gp)
    zero = [n for n, g in gc.items() if not bool((g != 0).any())]
    loss_rel = abs(lc - lp) / abs(lp)
    rel = {k: float(torch.linalg.norm(gc[k] - gp[k]) / torch.linalg.norm(gp[k]).clamp_min(1e-30))
           for k in gp}
    worst = max(rel, key=rel.get)
    print(f"{path}: step card vs CPU: loss rel {loss_rel:.3e} (bound {POSE_LOSS_BOUND:g}); "
          f"gradients relative L2 max {rel[worst]:.3e} at {worst} (bound {POSE_GRAD_BOUND:g}) "
          f"over {len(rel)} tensors; LeakyReLU decisions replayed: {decisions.flips} of "
          f"{decisions.elements} differed on the CPU; without a gradient {sorted(dead)}")
    if set(gc) != set(gp) or dead != feeds_nothing(task.model) or zero or not np.isfinite(
            [lc, lp]).all():
        raise AssertionError(f"{path}: gradients of {sorted(set(gc) ^ set(gp))}, none at "
                             f"{sorted(dead)}, zero at {zero}, losses {lc} {lp}")
    if not (loss_rel <= POSE_LOSS_BOUND and rel[worst] <= POSE_GRAD_BOUND):
        raise AssertionError(f"{path}: card step disagrees with the CPU")
    return {"loss_rel": loss_rel, "grad_rel_l2_max": rel[worst], "grad_rel_l2_at": worst,
            "leaky_flips": decisions.flips, "leaky_elements": decisions.elements,
            "grad_rel_l2_median": float(np.median(list(rel.values())))}


def pose_phase(cfg, out_dir: str, path: str = "pose") -> tuple:
    """Audio2pose: ``Trainer.fit`` of ``Audio2PoseTask`` under
    ``May/audio2pose.yaml``'s keys (batch 8, ``seq_len`` 200,
    ``recept_field`` 100, ``audio_in_dim`` 58) for 8 steps with a
    validation on a store the script writes, every loss finite and every
    live parameter's gradient non-zero, one step held against the CPU; then
    ``Audio2PoseInfer.infer`` of the ``asr`` path's DeepSpeech windows from
    the trained work dir → c2w ``[200, 4, 4]``, held against the CPU →
    (record, launches, sites)."""
    import numpy as np
    import torch

    from geneface_tpu_torch.config.config import load_config
    from geneface_tpu_torch.inference.audio2pose_infer import Audio2PoseInfer
    from geneface_tpu_torch.kernels import LAUNCHES
    from geneface_tpu_torch.tasks.audio2pose import Audio2PoseTask
    from geneface_tpu_torch.training.trainer import Trainer

    root = os.path.dirname(cfg["work_dir"])
    store = write_pose_store(os.path.join(root, "pose_store"))
    work = os.path.join(root, "pose_work")
    pcfg = dict(load_config(os.path.join(REPO, POSE_YAML)))
    pcfg.update(data_dir=store, work_dir=work, audio_in_dim=58, max_updates=POSE_STEPS,
                val_check_interval=POSE_STEPS, tb_log_interval=1, num_sanity_val_steps=0,
                eval_max_batches=4)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    task = Audio2PoseTask(pcfg)
    times, losses, step_fn = [], [], task.train_step

    def timed(batch):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = step_fn(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - ts) * 1e3)
        losses.append(float(out["total_loss"]))
        flat = {n for n, p in task.model.named_parameters()
                if p.grad is None or not bool((p.grad != 0).any())}
        if not np.isfinite(losses[-1]) or flat != feeds_nothing(task.model):
            raise AssertionError(f"{path}: loss {losses[-1]}, no gradient at {sorted(flat)}")
        return out

    task.train_step = timed
    t0 = time.perf_counter()
    assert Trainer(task).fit() == POSE_STEPS
    fit_s = time.perf_counter() - t0
    task.train_step = step_fn
    logged = [json.loads(line) for line in open(os.path.join(work, "metrics.jsonl"))]
    val = [m for m in logged if any(k.startswith("val/") for k in m)]
    if len(times) != POSE_STEPS or not val or not os.path.exists(
            os.path.join(work, f"model_ckpt_steps_{POSE_STEPS}.ckpt")):
        raise AssertionError(f"{path}: {len(times)} steps, validation {val}")
    median = float(np.median(times[2:]))
    batches = task.train_batches(0)
    batch = next(batches)
    prof = nerf_profile(lambda: task.train_step(batch), out_dir, f"{path}_step", median)
    check = pose_step_vs_cpu(task, next(batches), path)
    B, L = batch["audio"].shape[:2]
    print(f"{path}: Trainer.fit {POSE_STEPS} steps + validation in {fit_s:.1f} s; median "
          f"ms/step {median:.3f} over steps 2-{POSE_STEPS - 1} ({B} × {L} frames); steps ms "
          f"{[round(t, 3) for t in times]}; device busy {fmt_ms(prof['device_busy_ms'], ' ms')}"
          f", idle share {fmt_ms(prof['idle_share'])}, {prof['launches']} launches; losses "
          f"{[round(v, 6) for v in losses]}; validation {json.dumps(val[-1])}")

    # the rollout: the asr path's DeepSpeech windows → c2w
    npy = os.path.join(root, "asr", "deepspeech_win.npy")
    icfg = dict(pcfg, audio2pose_work_dir=work, pose_data_dir=store)
    infer = Audio2PoseInfer(icfg)
    out_npy = os.path.join(root, "pose_c2w.npy")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c2w = infer.infer(deepspeech_npy=npy, out_npy=out_npy)
    torch.cuda.synchronize()
    infer_ms = (time.perf_counter() - t0) * 1e3
    T = len(np.load(npy))
    if c2w.shape != (T, 4, 4) or not np.isfinite(c2w).all() or not np.array_equal(
            np.load(out_npy), c2w):
        raise AssertionError(f"{path}: c2w {c2w.shape}")
    cond = infer.get_cond_from_input(npy)
    roll_wall = host_ms(lambda: infer.rollout(cond), n=1)
    # the profiled window: the first frames only (all 200 are ~33,000 launches)
    head = cond[:POSE_PROFILE_FRAMES]
    roll = nerf_profile(lambda: infer.rollout(head), out_dir, f"{path}_rollout",
                        host_ms(lambda: infer.rollout(head), n=3))
    ref = Audio2PoseInfer(icfg, device="cpu").infer(deepspeech_npy=npy)
    errs = {"rollout_c2w": held(f"rollout c2w of {T} frames", c2w, ref, POSE_ROLLOUT_BOUND,
                                path=path)}
    R = infer.model.recept_field
    macs = R * (58 * 256 + 256 * 256 + 12 * 128 + 128 * 128 + 6 * (
        2 * 2 * 128 * 128 + 2 * 256 * 128 + 128 * 128 + 128 * 256) + 256 * 25 + 25 * 25)
    n_params = sum(p.numel() for p in infer.model.parameters())
    frame_bound = max(2 * macs / PEAK_F32_OPS_S, 4 * n_params / PEAK_BYTES_S) * 1e3
    launches = dict(LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"{path}: the pose path launched {launches}")
    per_frame = roll_wall / T
    print(f"{path}: Audio2PoseInfer.infer of {T} frames {infer_ms:.3f} ms (checkpoint read "
          f"before); rollout {roll_wall:.3f} ms = {per_frame:.3f} ms per rolled frame; device "
          f"busy {fmt_ms(roll['device_busy_ms'], ' ms')}, idle share "
          f"{fmt_ms(roll['idle_share'])} and launches per frame "
          f"{fmt_ms(None if roll['launches'] is None else roll['launches'] / len(head))} over "
          f"the first {len(head)} frames ({roll['wall_ms']:.3f} ms); bound per "
          f"frame {frame_bound * 1e3:.3f} µs ({2 * macs / 1e6:.1f} MFLOP over the {R}-wide "
          f"window at {PEAK_F32_OPS_S / 1e12:.0f} TFLOP/s float32); launches "
          f"{json.dumps(launches)} (the pose path runs neither kernel)")
    record = {"fit_s": fit_s, "ms_per_step": median, "steps_ms": times, "losses": losses,
              "validation": val[-1], "step_profile": prof, "step_vs_cpu": check,
              "infer_ms": infer_ms, "rollout_ms": roll_wall, "ms_per_rolled_frame": per_frame,
              "rollout_profile": roll, "rollout_frame_bound_ms": frame_bound,
              "card_vs_cpu_max_abs": errs,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    return record, launches, {}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    global CARD
    CARD = smi
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.time()
    build_log = build_kernels()
    print(f"kernels built in {time.time() - t0:.1f} s")
    out_dir = os.path.join(REPO, "smoke_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_build.log"), "w") as f:
        f.write(build_log)
    ptxas = ptxas_summary(build_log)
    for name, use in sorted(ptxas.items()):
        print(f"ptxas: {name} {use['registers']} registers, {use['spill_bytes']} bytes "
              f"spilled, {use['static_smem_bytes']} bytes static shared memory")

    root = os.path.join(REPO, ".smoke_work")
    shutil.rmtree(root, ignore_errors=True)
    try:
        cfg = write_scene(root, HW, N_FRAMES)
        phases = [("serve", serve_phase, cfg), ("train", train_phase, cfg),
                  ("ddp", ddp_phase, cfg),
                  ("torso_serve", serve_phase, torso_cfg(cfg)),
                  ("torso_train", train_phase, torso_cfg(cfg)),
                  ("audio_serve", audio_serve_phase, torso_cfg(cfg)),
                  ("audio_train", audio_train_phase, cfg),
                  ("train_lip", train_lip_phase, cfg),
                  ("import_serve", import_serve_phase, import_cfg(cfg)),
                  ("import_train", import_train_phase, import_cfg(cfg)),
                  ("datagen", datagen_phase, cfg),
                  ("nerf_serve", nerf_serve_phase, cfg),
                  ("nerf_train", nerf_train_phase, cfg),
                  ("asr", asr_phase, cfg),
                  ("pose", pose_phase, cfg)]
        record, launches, all_sites, per_call, took = {"gpu": smi}, {}, {}, {}, {}
        for path, phase, phase_cfg in phases:
            t1 = time.time()
            record[path], launches[path], sites = phase(phase_cfg, out_dir, path)
            took[path] = round(time.time() - t1, 1)
            chunks = record[path].get("sweep_launches_per_site", 1)
            per_call.update({s: chunks for s in sites if s.split(".")[0].endswith("sweep")})
            all_sites.update(sites)
        t3 = time.time()
        sites = measure_sites(all_sites, per_call)
        print(f"phases s: {json.dumps(took)}, kernel sites {time.time() - t3:.1f} s")
        print(f"profiler: {PROFILER['windows']} windows, "
              f"{PROFILER['windows_without_device_time']} without device time, "
              f"{PROFILER['windows_missing_launches']} missing launches; "
              f"{PROFILER['estimated_from_partial_windows']} times estimated from partial "
              f"windows, {PROFILER['timed_by_events']} taken by CUDA events instead; windows by "
              f"opening launches recorded (of {PAD_LAUNCHES}) "
              + json.dumps(PROFILER["opening_records"]) + "; rows "
              "that lost launches (windows, launches) " + json.dumps(dict(sorted(
                  PROFILER["short_rows"].items(), key=lambda r: -r[1][0])[:5])))
        kernels_line = {"kernels": [kernel_entry("scatter_add_rows", sites, launches, ptxas),
                                    kernel_entry("gather_rows", sites, launches, ptxas)]}
        record.update(kernels_line, profiler=PROFILER)
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
