"""Run a job on N gloo ranks on the CPU, for the port's data-parallel tests.

``run_ranks(job, spec, world, tmp)`` starts ``world`` processes of this
file with torchrun's environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR`` 127.0.0.1 and ``MASTER_PORT``); each joins the
group through :func:`geneface_tpu_torch.parallel.initialize_distributed`
with ``device="cpu"`` (or ``cuda:0``), runs ``JOBS[job](spec)`` and pickles the result to
``<tmp>/out_<rank>.pkl``. The parent waits with a timeout and returns the
results in rank order.

The parent holds the group's key-value store itself, bound to a port the
system picks, for the whole run, and the ranks join it as clients (torch's
``TORCHELASTIC_USE_AGENT_STORE``, as under torchrun's agent). A port that
was picked, released and handed to rank 0 a few seconds later could be
taken in between by a socket of another test's ranks (the suite runs in
parallel workers): a rank then joined the wrong group, or a stray
connection broke another group's rank ("Connection closed by peer").
The same step functions run in the parent's process without a process
group, which gives the one-rank reference.

Imports no JAX: the ranks start from a fresh interpreter.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from geneface_tpu_torch import parallel  # noqa: E402


def run_ranks(job: str, spec: dict, world: int, tmp: str, timeout: float = 240.0,
              device: str = "cpu") -> list:
    """Run ``JOBS[job](spec)`` on ``world`` gloo ranks → their results;
    ``device`` ``cuda:0``: the ranks share the card under gloo
    (``GF_DIST_BACKEND``)."""
    os.makedirs(tmp, exist_ok=True)
    spec_path = os.path.join(tmp, "spec.pkl")
    with open(spec_path, "wb") as f:
        pickle.dump({"job": job, "spec": spec, "device": device}, f)
    codes, logs = _start_ranks(spec_path, tmp, world, timeout)
    if any(c != 0 for c in codes):
        bad = [r for r, c in enumerate(codes) if c != 0]
        raise RuntimeError("\n".join(f"rank {r} exited with {codes[r]}:\n{logs[r][-6000:]}"
                                     for r in bad))
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"out_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _start_ranks(spec_path: str, tmp: str, world: int, timeout: float) -> tuple:
    """Host the group's store on a port of the system's choosing, start the
    ranks as its clients and wait for them → (exit codes, outputs); a rank
    that outlives ``timeout`` is killed."""
    store = dist.TCPStore("127.0.0.1", 0, world, is_master=True, wait_for_workers=False,
                          timeout=timedelta(seconds=timeout))
    procs = []
    for r in range(world):
        e = dict(os.environ, WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(store.port), OMP_NUM_THREADS="1",
                 GF_DIST_BACKEND="gloo", TORCHELASTIC_USE_AGENT_STORE="True")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), spec_path, tmp],
            env=e, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        del store
    return [p.returncode for p in procs], logs


# ------------------------------------------------------------------ steps --
def make_task(kind: str, cfg: dict, device: str = "cpu"):
    """A port task of ``kind`` on ``device``, float32 MLPs."""
    from geneface_tpu_torch.tasks.audio2motion import VAESyncAudio2MotionTask
    from geneface_tpu_torch.tasks.audio2pose import Audio2PoseTask
    from geneface_tpu_torch.tasks.lm3d_nerf import Lm3dNeRFTask
    from geneface_tpu_torch.tasks.postnet import PostnetAdvSyncTask
    from geneface_tpu_torch.tasks.radnerf import RADNeRFTask
    from geneface_tpu_torch.tasks.radnerf_torso import RADNeRFTorsoTask
    from geneface_tpu_torch.tasks.syncnet import SyncNetTask

    stage_a = {"nerf": Lm3dNeRFTask, "postnet": PostnetAdvSyncTask, "syncnet": SyncNetTask,
               "vae": VAESyncAudio2MotionTask, "audio2pose": Audio2PoseTask}
    if kind in stage_a:
        return stage_a[kind](cfg, device=device)
    cls = {"head": RADNeRFTask, "lip": RADNeRFTask, "torso": RADNeRFTorsoTask}[kind]
    return cls(cfg, device=device, dtype=torch.float32)


def step_result(kind: str, cfg: dict, batches: list, task_step: int = 0,
                state: dict | None = None, device: str = "cpu", skew: float = 0.0) -> dict:
    """Build the task (the mesh when a process group is up), load
    ``state`` (a checkpoint's), then one ``train_step`` per batch of
    ``batches`` from ``task_step``, recording the gradients each optimizer
    step applies (the post-net's two per step: the generator's, then the
    discriminator's) → ``{"losses": [..], "grads": [..], "occ": ..,
    "params": ..}`` as numpy. ``skew``: rank ``r`` adds ``skew · r`` to
    every gradient before the task averages them over the ranks (ranks
    whose gradients differ in their last bits, as K1's atomic order can
    make them on the card)."""
    task = make_task(kind, cfg, device)
    task.setup_mesh()
    task.build()
    if skew and task.mesh is not None:
        real_sync, rank = task.sync_grads, dist.get_rank()

        def skewed(params):
            params = list(params)
            for p in params:
                if p.grad is not None:
                    p.grad.add_(skew * rank)
            real_sync(params)

        task.sync_grads = skewed
    if state is not None:
        task.restore_state(state)
    task.place_state()
    task._step = task_step
    mods = {"": task.trainable() if hasattr(task, "trainable") else task.model}
    if hasattr(task, "disc"):
        mods["disc."] = task.disc
    named = [(pre + n, p) for pre, m in mods.items() for n, p in m.named_parameters()
             if p.requires_grad]
    names = {id(p): n for n, p in named}
    grads = []
    for attr in ("optimizer", "gen_opt", "disc_opt"):
        opt = getattr(task, attr, None)
        if opt is None:
            continue
        params = [p for g in opt.param_groups for p in g["params"]]

        def recording(real=opt.step, params=params):
            grads.append({names[id(p)]: p.grad.detach().cpu().numpy() for p in params
                          if p.grad is not None})
            real()

        opt.step = recording
    losses = []
    for batch in batches:
        m = task.train_step(batch)
        losses.append({k: float(v) for k, v in m.items()})
    out = {"losses": losses, "grads": grads,
           "params": {n: p.detach().cpu().numpy() for n, p in named}}
    if hasattr(task, "occ"):
        out["occ"] = [np.asarray(x.cpu()) for x in task.occ]
    if hasattr(task, "torso_occ"):
        out["torso_occ"] = [np.asarray(x.cpu()) for x in task.torso_occ]
    return out


def loss_grads(kind: str, cfg: dict, batch: dict, state: dict, noises: np.ndarray,
               step: int, rays: tuple | None = None, lpips: dict | None = None) -> dict:
    """One RAD-NeRF loss (head, lip or torso) and its gradient at a
    checkpoint's ``state``, with the global ``noises`` (and, for a dense
    patch, the global ``rays``) given: this rank's rows of each, the
    gradients averaged and the metrics reduced over the mesh →
    ``{"losses", "grads"}`` as numpy."""
    task = make_task(kind, cfg)
    task.setup_mesh()
    task.build()
    task.restore_state(state)
    if lpips is not None:
        task.lpips.load_state_dict({k: torch.as_tensor(v) for k, v in lpips.items()})
    local, _ = task.split_batch(batch, "inds")
    tb = task.device_batch(local, step)
    if rays is not None:
        tb["rays_o"], tb["rays_d"] = (task.local_rows(torch.as_tensor(r)) for r in rays)
    noise = task.local_rows(torch.tensor(noises))
    args = dict(lip=True) if kind == "lip" else {}
    total, losses = task.loss_fn(tb, noise, train=True, **args)
    total.backward()
    task.sync_grads(task.model.parameters())
    losses = task.reduce_metrics({k: v.detach() for k, v in losses.items()},
                                 max_keys=("march_span",))
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": {n: p.grad.numpy().copy() for n, p in task.model.named_parameters()
                      if p.grad is not None}}


def postnet_grads(cfg: dict, variables: dict, lrs3: dict, person: dict, clip_idx: tuple,
                  noises: tuple, adv_on: float, fake) -> dict:
    """The post-net's generator and discriminator losses and gradients at
    the flax ``variables`` of its generator, discriminator and frozen VAE,
    with the global prior ``noises`` and refinement ``fake`` given: this
    rank's clips of each, the gradients averaged and the metrics reduced
    over the mesh → ``{"losses", "gen", "disc"}`` as numpy."""
    from geneface_tpu_torch.convert import load_flax_variables
    from geneface_tpu_torch.tasks.syncnet import to_device

    task = make_task("postnet", cfg)
    task.setup_mesh()
    task.build()
    for attr, v in variables.items():
        load_flax_variables(getattr(task, attr), v)
    keys = task.keys()
    rows = (len(lrs3["y"]), len(person["y"]))
    tl, tp = (to_device(task.place_batch(b), keys, "cpu") for b in (lrs3, person))
    noise = tuple(task.local_rows(torch.tensor(n)) for n in noises)
    total, losses, _ = task.gen_loss(tl, tp, clip_idx, noise, adv_on, rows)
    total.backward()
    task.sync_grads(task.model.parameters())
    d_total, d_losses = task.disc_loss(task.local_rows(torch.tensor(fake)), tp["y"],
                                       tp["y_mask"], rows)
    d_total.backward()
    task.sync_grads(task.disc.parameters())
    losses = task.reduce_metrics({k: v.detach() for k, v in {**losses, **d_losses}.items()})
    return {"losses": {k: float(v) for k, v in losses.items()},
            **{attr: {n: p.grad.numpy().copy() for n, p in getattr(task, mod).named_parameters()
                      if p.grad is not None} for attr, mod in (("gen", "model"), ("disc", "disc"))}}


def nerf_grads(cfg: dict, params: dict, batch: dict, noise: dict, step: int) -> dict:
    """The vanilla NeRF head's loss and gradient at the flax ``params``,
    with the global draws ``noise`` (``t_rand``, ``u``) given: this rank's
    rays, the gradient averaged and the metrics reduced over the mesh; and
    the rank's fine samples and backbone ReLU decisions (row blocks of the
    global ones), in call order, for the JAX side to replay →
    ``{"losses", "grads", "samples", "masks"}`` as numpy."""
    from geneface_tpu_torch.convert import nerf_flax_to_state_dict
    from geneface_tpu_torch.tasks import lm3d_nerf

    task = make_task("nerf", cfg)
    task.setup_mesh()
    task.build()
    task.model.load_state_dict({k: torch.as_tensor(v)
                                for k, v in nerf_flax_to_state_dict(params).items()})
    task._step = step
    samples, masks, hooks = [], [], []
    real = lm3d_nerf.render_rays

    def recording(*args, **kw):
        out = real(*args, **kw)
        samples.append(out["z_samples"].detach().numpy())
        return out

    for net in ("model_coarse", "model_fine"):
        backbone = getattr(task.model, net)
        skip = (backbone.num_density_linears, len(backbone.layers) - 1)  # sigma, rgb
        hooks += [layer.register_forward_hook(lambda m, i, o: masks.append(o.detach().numpy() > 0))
                  for k, layer in enumerate(backbone.layers) if k not in skip]
    lm3d_nerf.render_rays = recording
    try:
        local, _ = task.split_batch(batch, "rays_o")
        draws = {k: task.local_rows(torch.tensor(v)) for k, v in noise.items()}
        total, losses = task.loss_fn(task.device_batch(local), draws, task.with_att())
        total.backward()
    finally:
        lm3d_nerf.render_rays = real
        for h in hooks:
            h.remove()
    task.sync_grads(task.model.parameters())
    losses = task.reduce_metrics({k: v.detach() for k, v in losses.items()})
    return {"losses": {k: float(v) for k, v in losses.items()}, "samples": samples,
            "masks": masks, "grads": {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                                      .numpy().copy() for n, p in task.model.named_parameters()}}


def job_steps(spec: dict) -> dict:
    out = {}
    for name, case in spec["cases"].items():
        fn = {"grads": loss_grads, "postnet": postnet_grads,
              "nerf": nerf_grads}.get(case.pop("fn", None), step_result)
        out[name] = fn(**case)
    return out


def job_fit(spec: dict) -> dict:
    """``Trainer.fit`` of the head to ``max_updates`` → the final state."""
    from geneface_tpu_torch.training.trainer import Trainer

    task = make_task("head", spec["cfg"])
    Trainer(task).fit()
    return {"params": {n: p.detach().numpy().copy() for n, p in task.model.named_parameters()},
            "occ": [np.asarray(x) for x in task.occ], "step": task._step,
            "mesh": parallel.data_size(task.mesh)}


def job_render(spec: dict) -> dict:
    """``RADNeRFInfer.render_video`` split over the ranks; rank 0's frames
    are caught at ``save_mp4``."""
    from geneface_tpu_torch.inference import radnerf_infer

    caught = {}

    def save(frames, out_path, **kw):
        caught["frames"] = np.asarray(frames)
        return out_path

    radnerf_infer.save_mp4 = save
    infer = radnerf_infer.RADNeRFInfer(spec["cfg"], device="cpu")
    path = infer.render_video(n_frames=spec["n_frames"], out_path=spec["out_path"])
    return {"path": path, "frames": caught.get("frames")}


def job_mesh(spec: dict) -> dict:
    """The mesh helpers and the global waterfill on this rank's block."""
    import torch.distributed as dist

    from geneface_tpu_torch.ops.compaction import waterfill_valid

    out = {}
    mesh = parallel.make_mesh()
    out["shape"] = tuple(mesh.shape)
    mesh2 = parallel.make_mesh(n_data=1, n_model=2)
    out["shape_2d"] = tuple(mesh2.shape)
    out["dims_2d"] = tuple(mesh2.mesh_dim_names)
    out["shard"] = parallel.shard_batch(mesh, spec["batch"])
    out["slice"] = parallel.host_local_slice(spec["global_len"], mesh)
    # the global-batch check: equal batches pass, one differing rank raises
    os.environ["GF_CHECK_GLOBAL_BATCH"] = "1"
    parallel.put_sharded(mesh, spec["batch"]["rays"], True)
    bad = spec["batch"]["rays"] + (parallel.rank() == 1)
    try:
        parallel.put_sharded(mesh, bad, True)
        out["check_raised"] = False
    except AssertionError:
        out["check_raised"] = True
    del os.environ["GF_CHECK_GLOBAL_BATCH"]
    # the waterfill of this rank's rows of the global mask, at the global budget
    group = mesh.get_group(parallel.DATA_AXIS)
    valid = torch.as_tensor(parallel.local_rows(mesh, spec["mask"]))
    out["waterfill"] = waterfill_valid(valid, spec["capacity"], group).numpy()
    out["waterfill_alone"] = waterfill_valid(valid, spec["capacity"] // 2).numpy()
    # the differentiable gather: a replicated parameter θ, rank r's rows
    # (r + 1)·θ + 10r, one loss of all rows on every rank, θ's gradient
    # averaged as the trainer averages it
    theta = torch.ones(2, 2, requires_grad=True)
    r = dist.get_rank()
    g = parallel.all_gather_rows(mesh, theta * (r + 1) + 10 * r)
    (g * torch.as_tensor(spec["weights"])).sum().backward()
    out["gathered"] = g.detach().numpy()
    grad = theta.grad.clone()
    dist.all_reduce(grad, group=group)
    out["gather_grad"] = (grad / parallel.data_size(mesh)).numpy()
    return out


JOBS = {"steps": job_steps, "fit": job_fit, "render": job_render, "mesh": job_mesh}


def _rank_main(spec_path: str, tmp: str) -> None:
    torch.set_num_threads(1)
    with open(spec_path, "rb") as f:
        job = pickle.load(f)
    parallel.initialize_distributed(job["device"])
    try:
        result = JOBS[job["job"]](job["spec"])
        with open(os.path.join(tmp, f"out_{parallel.rank()}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
