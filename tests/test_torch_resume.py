"""Resume, the checkpoint policy and the validation-end hook of the port's
trainer against the JAX trainer, on the tiny config of
``tests/test_torch_training.py`` (64² synthetic scene, 256 rays, widths
16).

Tolerances, per check:
- the port's checkpoint round trip (``count``, ``skipped``, ``mu``, ``nu``,
  the accumulator, parameters, occupancy, ``task_step``): bit-identical;
- the step after a JAX-written checkpoint (step 2) at float32 MLPs, with the
  same batch and noise: every parameter within rtol 1e-4 and atol 1e-5 ×
  max |p| of the JAX step's (the gradient's bounds of
  ``test_train_step_loss_and_grads_match``; Adam divides by the moments, so
  parameters inherit the gradients' relative error);
- ``accumulate_grad_batches: 2`` over 5 micro-steps, one with a NaN: every
  parameter within atol 1e-7 and rtol 1e-6 of ``apply_if_finite(MultiSteps(
  ...))``, the counts exact; the same bounds for the 2 micro-steps after a
  JAX-written ``MultiStepsState`` is restored;
- the work-dir listings of a 4-step run of each trainer: equal, but for the
  JAX run's TensorBoard directory ``tb/`` (the port logs no TensorBoard);
- the full val frame at the bf16 default: max abs 1e-3 and mean abs 1e-6
  per pixel (the bf16 bounds of ``tests/test_torch_infer.py``).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geneface_tpu.config import Config as JConfig
from geneface_tpu.models.radnerf import RADNeRF as JRADNeRF
from geneface_tpu.models.radnerf.renderer import OccupancyState as JOcc
from geneface_tpu.models.radnerf.renderer import TorsoOccupancyState as JTorsoOcc
from geneface_tpu.tasks.radnerf import RADNeRFTask as JTask
from geneface_tpu.tasks.radnerf import model_from_cfg as jmodel_from_cfg
from geneface_tpu.tasks.radnerf_torso import RADNeRFTorsoTask as JTorsoTask
from geneface_tpu.training import schedules as jsched
from geneface_tpu.training.optim import finalize_optimizer, multi_group_adam
from geneface_tpu.training.optim import radnerf_label_fn as jlabel
from geneface_tpu.training.trainer import Trainer as JTrainer
from geneface_tpu.utils import load_checkpoint as jload_checkpoint
from geneface_tpu.utils.checkpoint import save_checkpoint as jsave_checkpoint
from geneface_tpu_torch.convert import flax_path, flax_to_state_dict
from geneface_tpu_torch.models.radnerf import (
    OccupancyState,
    TorsoOccupancyState,
    model_from_cfg,
)
from geneface_tpu_torch.tasks.radnerf import RADNeRFTask
from geneface_tpu_torch.tasks.radnerf_torso import RADNeRFTorsoTask
from geneface_tpu_torch.training import schedules
from geneface_tpu_torch.training.optim import build_optimizer
from geneface_tpu_torch.training.trainer import Trainer
from geneface_tpu_torch.utils.checkpoint import (
    adam_state_from_optax,
    load_checkpoint,
    save_checkpoint,
)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.make_synthetic_dataset import make_dataset  # noqa: E402

from test_torch_torso_training import _ball  # noqa: E402
from test_torch_torso_training import tiny_cfg as torso_tiny_cfg  # noqa: E402
from test_torch_training import _tiny_models, tiny_cfg  # noqa: E402

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)


def run_cfg(data, work, **over):
    """4 steps, validation (and a checkpoint) every 2, both kept; the
    terminal mirrored to ``terminal_logs/``, the sources copied to
    ``codes/``, step 1 traced to ``profile/``."""
    return tiny_cfg(data, work, max_updates=4, val_check_interval=2, tb_log_interval=2,
                    num_sanity_val_steps=1, eval_max_batches=1, num_ckpt_keep=2,
                    mean_samples_per_ray=8, lattice_K=32, tee_logs=True, save_codes=True,
                    profile_steps=1, profile_start_step=1, **over)


def fit_untee(trainer):
    """``trainer.fit()``, then stdout and stderr as they were (``tee_logs``
    wraps them)."""
    out, err = sys.stdout, sys.stderr
    try:
        return trainer.fit()
    finally:
        sys.stdout, sys.stderr = out, err


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_resume")
    make_dataset(str(root / "data"), n_frames=12, hw=64)
    return root


@pytest.fixture(scope="module")
def tiny_params(scene):
    """JAX-initialized parameters of the tiny head (one init for the
    optimizer tests: their configs differ only in optimizer keys)."""
    return _tiny_models(tiny_cfg(str(scene / "data"), ""))[1]


def _port_model(cfg, params):
    model = model_from_cfg(cfg, dtype=torch.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in flax_to_state_dict(params).items()})
    return model


@pytest.fixture(scope="module")
def jax_run(scene):
    """The JAX trainer's 4-step run: its config, task and final state."""
    cfg = run_cfg(str(scene / "data"), str(scene / "jax_run"))
    trainer = JTrainer(JTask(JConfig(cfg)))
    state = fit_untee(trainer)
    return cfg, trainer.task, state


def _listing(work):
    top = sorted(f for f in os.listdir(work) if f != "tb")
    images = {d: sorted(os.listdir(os.path.join(work, "images", d)))
              for d in os.listdir(os.path.join(work, "images"))}
    return top, images


def test_work_dir_matches_jax_run(jax_run, scene):
    """The Queue 3 repair: the port's run writes what the JAX run writes,
    the best-val checkpoint and the val frame's image included, and logs
    ``val/full_frame_psnr`` at the same steps."""
    cfg, _, _ = jax_run
    work = str(scene / "port_run")
    assert fit_untee(Trainer(RADNeRFTask(dict(cfg, work_dir=work), device="cpu"))) == 4
    want, got = _listing(cfg["work_dir"]), _listing(work)
    assert got == want
    assert "model_ckpt_best.ckpt" in got[0] and got[1] == {"val_render": [
        "step_2.png", "step_4.png"]}
    # what tee_logs, save_codes and profile_steps wrote
    (codes,) = os.listdir(os.path.join(work, "codes"))
    for src in ("tasks/radnerf.py", "training/trainer.py", "csrc/scatter_add_rows.cu"):
        assert os.path.exists(os.path.join(work, "codes", codes, src)), src
    (log,) = os.listdir(os.path.join(work, "terminal_logs"))
    assert "| validation @ 4" in open(os.path.join(work, "terminal_logs", log)).read()
    assert os.listdir(os.path.join(work, "profile")) == ["trace_steps_1_2.json"]

    def psnr_steps(w):
        rows = [json.loads(x) for x in open(os.path.join(w, "metrics.jsonl"))]
        return [r["step"] for r in rows if "val/full_frame_psnr" in r]

    assert psnr_steps(work) == psnr_steps(cfg["work_dir"]) == [2, 4]


def _assert_same_state(a: dict, b: dict, path=""):
    assert type(a) is type(b) or (isinstance(a, tuple) and isinstance(b, tuple)), path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same_state(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, tuple):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_state(x, y, f"{path}/{i}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
        assert np.asarray(a).dtype == np.asarray(b).dtype, path


@pytest.mark.parametrize("kind", ["head", "torso", "head_accumulating"])
def test_port_checkpoint_round_trip_is_bit_identical(scene, tmp_path, kind):
    """Three steps, a checkpoint, a fresh task restored from it: the
    optimizer state (with MultiSteps' accumulator after an odd micro-step),
    parameters, occupancy and ``task_step`` come back bit for bit, and the
    next step of both tasks is the same."""
    data = str(scene / "data")
    if kind == "torso":
        cfg, cls = torso_tiny_cfg(data), RADNeRFTorsoTask
    else:
        extra = {"accumulate_grad_batches": 2} if kind == "head_accumulating" else {}
        cfg, cls = tiny_cfg(data, "", mean_samples_per_ray=8, lattice_K=32, **extra), RADNeRFTask
    task = cls(cfg, device="cpu")
    task.build()
    batches = task.train_batches(0)
    for _ in range(3):
        task.train_step(next(batches))
    payload = task.checkpoint_payload(3)
    path = str(tmp_path / "model_ckpt_steps_3.ckpt")
    save_checkpoint(path, payload)
    loaded = load_checkpoint(path)
    opt = loaded["state"]["opt_state"]
    assert int(opt["count"]) == (1 if kind == "head_accumulating" else 3)
    assert loaded["extra"] == {"task_step": 3}

    fresh = cls(cfg, device="cpu")
    fresh.build()
    fresh.restore_state(loaded["state"])
    fresh.on_restore(loaded["extra"])
    assert fresh._step == task._step == 3
    _assert_same_state(fresh.checkpoint_payload(3), payload)
    if kind == "head_accumulating":
        assert int(fresh.optimizer.mini_step) == 1
        assert any(np.abs(v).max() > 0 for v in flax_to_state_dict(opt["acc_grads"]).values())
    # the same batch and noise: the same update (the capacity buckets are
    # not checkpointed, in either package: the restored task re-picks them
    # at its first step, and here both render at the same capacities)
    assert fresh.render_kwargs() == dict(task.render_kwargs(), **(
        {} if kind == "torso" else {"mean_samples_per_ray": 8.0, "lattice_K": 32}))
    batch = next(batches)
    for t in (task, fresh):
        t.generator.manual_seed(123)
        t.train_step(batch)
    for (n, p), q in zip(task.model.named_parameters(), fresh.model.parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=0, msg=n)


def test_jax_checkpoint_resumes_with_the_next_step_matching(jax_run):
    """The JAX trainer's step-2 checkpoint (optax's pickled state) read by
    the port: its Adam moments and counts arrive, and one more step with the
    same batch and noise at float32 MLPs gives the JAX step's parameters."""
    cfg, jtask, _ = jax_run
    ckpt = jload_checkpoint(os.path.join(cfg["work_dir"], "model_ckpt_steps_2.ckpt"))
    task = RADNeRFTask(cfg, device="cpu", dtype=torch.float32)
    task.build()
    state = load_checkpoint(os.path.join(cfg["work_dir"], "model_ckpt_steps_2.ckpt"))
    task.restore_state(state["state"])
    task.on_restore(state["extra"])
    assert task._step == 2 and int(task.optimizer.count) == 2
    assert int(task.optimizer.skipped) == int(ckpt["state"]["opt_state"].total_notfinite)
    grid = ckpt["state"]["opt_state"].inner_state.inner_states["grid"].inner_state[0]
    table = dict(task.model.named_parameters())["pos_embeddings.group_0"]
    for k in ("mu", "nu"):
        np.testing.assert_array_equal(task.optimizer.state[table][k].numpy(),
                                      getattr(grid, k)["params"]["pos_embeddings"]["group_0"])

    # the JAX step at float32 MLPs, from the checkpoint's state
    jtask.model = jmodel_from_cfg(JConfig(cfg), JRADNeRF, dtype=jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, ckpt["state"]["params"])
    occ = JOcc(*map(jnp.asarray, ckpt["state"]["occ"]))
    opt_state = jax.tree_util.tree_map(jnp.asarray, ckpt["state"]["opt_state"])
    batch = jtask.train_ds[5]
    dbatch = jtask._device_batch(batch, 2)
    rng = jax.random.PRNGKey(11)

    @jax.jit
    def jstep(params, opt_state):
        grads = jax.grad(lambda p: jtask._loss_fn(p, occ, dbatch, rng, train=True)[0])(params)
        updates, _ = jtask.tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates)

    want = flax_to_state_dict(jstep(params, opt_state))
    noises = torch.from_numpy(np.asarray(jax.random.uniform(rng, (len(batch["inds"]),))))
    task.optimizer.zero_grad(set_to_none=True)
    loss, _ = task.loss_fn(task.device_batch(batch, 2), noises, train=True)
    loss.backward()
    task.optimizer.step()
    assert int(task.optimizer.count) == 3
    for name, p in task.model.named_parameters():
        scale = float(np.abs(want[name]).max())
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("clip", [{}, {"clip_grad_norm": 0.5}])
def test_gradient_accumulation_matches_optax_multisteps(scene, tiny_params, clip):
    cfg = tiny_cfg(str(scene / "data"), "", scheduler="warmup", warmup_updates=2,
                   accumulate_grad_batches=2, **clip)
    params = jax.tree_util.tree_map(np.array, tiny_params)
    tmodel = _port_model(cfg, params)
    tx = multi_group_adam(
        params, jsched.build_schedule(cfg), jlabel, {"net": 1.0, "grid": 10.0, "att": 5.0},
        eps=1e-15, clip_grad_norm=cfg.get("clip_grad_norm", 0),
    )
    tx = finalize_optimizer(tx, JConfig(cfg))  # apply_if_finite(MultiSteps(...))
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    opt = build_optimizer(tmodel, schedules.build_schedule(cfg), cfg)
    rng = np.random.RandomState(0)
    named = dict(tmodel.named_parameters())
    for step in range(5):
        grads = jax.tree_util.tree_map(
            lambda p: rng.randn(*p.shape).astype(np.float32) * 0.03, params)
        if step == 1:  # a non-finite micro-batch: skipped, not accumulated
            grads["params"]["sigma_net"]["Dense_0"]["kernel"][0, 0] = np.nan
        upd, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, upd)
        for name, g in flax_to_state_dict(grads).items():
            named[name].grad = torch.from_numpy(g)
        opt.step()
        for name, want in flax_to_state_dict(params).items():
            np.testing.assert_allclose(named[name].detach().numpy(), want, atol=1e-7,
                                       rtol=1e-6, err_msg=f"{name} after micro-step {step}")
        multi = opt_state.inner_state
        assert int(opt.mini_step) == int(multi.mini_step), step
        assert int(opt.skipped) == int(opt_state.total_notfinite), step
    # 4 accepted micro-batches: 2 updates; the NaN one counted as skipped
    assert (int(opt.count), int(opt.skipped), int(opt.mini_step)) == (2, 1, 0)
    part = multi.inner_opt_state  # clipping chains its EmptyState first
    part = part if hasattr(part, "inner_states") else part[-1]
    adam_count = part.inner_states["net"].inner_state[0].count
    assert int(adam_count) == 2


@pytest.mark.parametrize("jax_steps", [2, 3])
def test_jax_accumulating_run_resumes_in_the_port(scene, tiny_params, tmp_path, jax_steps):
    """A JAX run at ``accumulate_grad_batches: 2`` (``apply_if_finite(
    MultiSteps(...))``) takes ``jax_steps`` micro-steps and is checkpointed
    by the JAX package; the port's task restores the checkpoint (after 3
    micro-steps, the accumulator holds one), and the next 2 micro-steps on
    both sides, with the same gradients, leave every parameter within the
    accumulation test's atol 1e-7 and rtol 1e-6."""
    cfg = tiny_cfg(str(scene / "data"), "", accumulate_grad_batches=2)
    params = jax.tree_util.tree_map(np.array, tiny_params)
    tx = finalize_optimizer(multi_group_adam(
        params, jsched.build_schedule(cfg), jlabel, {"net": 1.0, "grid": 10.0, "att": 5.0},
        eps=1e-15), JConfig(cfg))
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    rng = np.random.RandomState(7)

    def grads():
        return jax.tree_util.tree_map(
            lambda p: rng.randn(*p.shape).astype(np.float32) * 0.03, params)

    for _ in range(jax_steps):
        upd, opt_state = update(grads(), opt_state, params)
        params = optax.apply_updates(params, upd)
    occ = JOcc(jnp.zeros((1, 32**3)), jnp.zeros((1, 32, 32, 32), bool), jnp.zeros(()))
    path = str(tmp_path / f"model_ckpt_steps_{jax_steps}.ckpt")
    jsave_checkpoint(path, {"state": {"params": params, "occ": occ, "opt_state": opt_state},
                            "step": jax_steps})

    task = RADNeRFTask(cfg, device="cpu", dtype=torch.float32)
    task.build()
    task.restore_state(load_checkpoint(path)["state"])
    opt = task.optimizer
    assert int(opt.mini_step) == jax_steps % 2 and int(opt.count) == jax_steps // 2
    named = dict(task.model.named_parameters())
    for _ in range(2):
        g = grads()
        upd, opt_state = update(g, opt_state, params)
        params = optax.apply_updates(params, upd)
        for name, v in flax_to_state_dict(g).items():
            named[name].grad = torch.from_numpy(v)
        opt.step()
    assert int(opt.count) == (jax_steps + 2) // 2
    for name, want in flax_to_state_dict(params).items():
        np.testing.assert_allclose(named[name].detach().numpy(), want, atol=1e-7, rtol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("layout", ["guarded", "clipped", "unguarded", "accumulating"])
def test_optax_state_layouts_read(scene, tiny_params, tmp_path, layout):
    """Each optax state the JAX trainer pickles for the head config (the
    default ``apply_if_finite`` guard, clipping's ``EmptyState`` chained in
    front, no guard, and ``MultiSteps`` inside the guard) reads back as the
    port's ``{count, skipped, mu, nu}`` without optax, with MultiSteps'
    ``mini_step`` and ``acc_grads``."""
    over = {"clipped": {"clip_grad_norm": 0.5}, "unguarded": {"guard_nan_grads": False},
            "accumulating": {"accumulate_grad_batches": 2}}.get(layout, {})
    cfg = tiny_cfg(str(scene / "data"), "", **over)
    params = tiny_params
    tx = finalize_optimizer(multi_group_adam(
        params, jsched.build_schedule(cfg), jlabel, {"net": 1.0, "grid": 10.0, "att": 5.0},
        eps=1e-15, clip_grad_norm=cfg.get("clip_grad_norm", 0)), JConfig(cfg))
    state = tx.init(params)
    update = jax.jit(tx.update)
    rng = np.random.RandomState(1)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.randn(*p.shape).astype(np.float32), params)
        if step == 1:
            grads["params"]["sigma_net"]["Dense_0"]["kernel"][0, 0] = np.inf
        state = update(grads, state, params)[1]
    path = str(tmp_path / "model_ckpt_steps_3.ckpt")
    jsave_checkpoint(path, {"state": {"opt_state": state}, "step": 3})
    opt = load_checkpoint(path)["state"]["opt_state"]
    got = adam_state_from_optax(opt)
    part = state
    while not hasattr(part, "inner_states"):  # unwrap the guard, MultiSteps, the chain
        part = (part.inner_state if hasattr(part, "inner_state") else
                part.inner_opt_state if hasattr(part, "inner_opt_state") else part[-1])
    # accumulating: 2 accepted micro-batches of 2 make one update
    want_count = {"unguarded": 3, "accumulating": 1}.get(layout, 2)
    assert int(got["count"]) == want_count
    if layout == "accumulating":
        multi = state.inner_state
        assert int(got["mini_step"]) == int(multi.mini_step) == 0
        for name, want in flax_to_state_dict(multi.acc_grads).items():
            np.testing.assert_array_equal(flax_to_state_dict(got["acc_grads"])[name], want)
    else:
        assert "acc_grads" not in got
    assert int(got["skipped"]) == (0 if layout == "unguarded" else 1)
    for k in ("mu", "nu"):
        for name, group in (("sigma_net.layers.0.weight", "net"),
                            ("pos_embeddings.group_1", "grid"),
                            ("cond_att_net.fc.bias", "att")):
            want = getattr(part.inner_states[group].inner_state[0], k)["params"]
            have = got[k]["params"]
            for key in flax_path(name):
                want, have = want[key], have[key]
            np.testing.assert_array_equal(have, np.asarray(want), err_msg=f"{k} {name}")
        assert set(flax_to_state_dict(got[k])) == set(flax_to_state_dict(params))


@pytest.mark.parametrize("kind", ["head", "torso"])
def test_render_full_frame_matches_jax(jax_run, scene, kind):
    if kind == "head":
        cfg, jtask, jstate = jax_run
        task = RADNeRFTask(cfg, device="cpu")  # the bf16 default, as the JAX task's
        task.build()
        task.restore_state(load_checkpoint(
            os.path.join(cfg["work_dir"], "model_ckpt_steps_4.ckpt"))["state"])
        # the lattice budget the JAX task had retuned when it first rendered
        task._latk_bucket = jtask._latk_bucket
    else:
        cfg = torso_tiny_cfg(str(scene / "data"))
        jtask = JTorsoTask(JConfig(cfg))
        jstate = jtask.build()
        params = jax.tree_util.tree_map(np.array, jstate["params"])
        params["params"]["sigma_net"]["Dense_1"]["kernel"][:, 0] += 0.5  # a dense head
        dens, occ = _ball(cfg["grid_size"])
        torso = np.zeros((cfg["grid_size"], cfg["grid_size"]), np.float32)
        torso[:, cfg["grid_size"] // 2:] = 0.5  # the lower half of the screen
        jstate = dict(jstate, params=params, occ=JOcc(dens, occ, np.float32(0.0)),
                      torso_occ=JTorsoOcc(torso.reshape(-1), np.float32(torso.mean())))
        task = RADNeRFTorsoTask(cfg, device="cpu")
        task.build()
        task.model.load_state_dict(
            {k: torch.from_numpy(v) for k, v in flax_to_state_dict(params).items()})
        task.set_occupancy(OccupancyState(torch.from_numpy(dens), torch.from_numpy(occ),
                                          torch.tensor(0.0)))
        task.torso_occ = TorsoOccupancyState(torch.from_numpy(torso.reshape(-1)),
                                             torch.tensor(float(torso.mean())))
    want, want_gt = jtask.render_full_frame(jstate)
    got, gt = task.render_full_frame()
    np.testing.assert_array_equal(gt, want_gt)
    assert got.shape == want.shape == (64, 64, 3)
    assert np.abs(want - task.val_ds._bg_torso(task.val_ds.samples[0])).max() > 0.02
    err = np.abs(got - want)
    assert err.max() <= 1e-3 and err.mean() <= 1e-6, (err.max(), err.mean())
