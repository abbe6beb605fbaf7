"""The RAD-NeRF head's training step split over two gloo ranks on the CPU
(``tests/torch_ddp_helpers.py``) against the same step on one rank and
against the JAX task's step on a two-device mesh, on the tiny config of
``tests/test_torch_training.py`` at 1,024 rays and ``mean_samples_per_ray``
2, where the sample budget binds (so the global waterfill decides which
samples each rank keeps).

Tolerances, per check:
- two ranks against one (``train_step``: the sweep, the split batch, the
  jitter drawn globally, the waterfill over both ranks, the gradient
  average, Adam): each step's loss within rel 1e-6, every parameter's
  gradient within relative L2 1e-5 (the split only regroups sums), the
  occupancy grids after the sweep bit-equal across the ranks and to the
  one-rank run's, the parameters after ``Trainer.fit`` bit-equal across
  the ranks;
- two ranks against the JAX step on ``make_mesh(devices=jax.devices()[:2])``
  (jitted ``value_and_grad`` of the JAX loss on the sharded batch, the same
  parameters, occupancy and march noise): the bounds of
  ``tests/test_torch_training.py`` and ``tests/test_torch_lip.py`` — loss
  rel 1e-5, gradients rtol 1e-4 and atol 1e-5 × max |g|; the lip patch's
  rays are the JAX package's on both sides, as in ``test_torch_lip.py``.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneface_tpu.config import Config as JConfig
from geneface_tpu.data.radnerf_dataset import RADNeRFDataset as JDataset
from geneface_tpu.models.radnerf import RADNeRF as JRADNeRF
from geneface_tpu.models.radnerf.renderer import OccupancyState as JOcc
from geneface_tpu.parallel import make_mesh as jmake_mesh
from geneface_tpu.tasks.radnerf import RADNeRFTask as JTask
from geneface_tpu.tasks.radnerf import model_from_cfg as jmodel_from_cfg
from geneface_tpu_torch.convert import flax_to_state_dict, lpips_state_dict, state_dict_to_flax
from geneface_tpu_torch.data.radnerf_dataset import RADNeRFDataset
from geneface_tpu_torch.models.radnerf import renderer as trenderer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import torch_ddp_helpers as ddp  # noqa: E402
from test_torch_training import tiny_cfg  # noqa: E402
from tools.make_synthetic_dataset import make_dataset  # noqa: E402

torch.set_num_threads(1)

STEP = 1000  # the ambient loss's ramp is on at this step


def head_cfg(data_dir, work_dir="", **over):
    return tiny_cfg(data_dir, work_dir, **dict(dict(n_rays=1024, mean_samples_per_ray=2,
                                                    lattice_K=32), **over))


def lip_cfg(data_dir, **over):
    return head_cfg(data_dir, finetune_lips=True, finetune_lips_start_iter=4,
                    lip_patch_size=32, allow_random_lpips=True, lambda_lpips_loss=0.01,
                    mean_samples_per_ray=8, **over)


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_ddp")
    data = str(root / "data")
    make_dataset(data, n_frames=12, hw=64)
    return root, data


def _jtask(cfg, data):
    """The JAX task with the parts of ``build()`` its loss reads, on a
    two-device mesh."""
    jtask = JTask(JConfig(cfg))
    jtask.model = jmodel_from_cfg(JConfig(cfg), JRADNeRF, dtype=jnp.float32)
    jtask.train_ds = JDataset("train", cfg["data_dir"], JConfig(cfg), training=True)
    jtask.grid_size = int(cfg["grid_size"])
    jtask.lpips = None
    jtask.mesh = jmake_mesh(devices=jax.devices()[:2])
    return jtask


@pytest.fixture(scope="module")
def jax_case(scene):
    """Parameters, occupancy (one sweep) and LPIPS weights shared by both
    packages, the batches, and the JAX noise and lip rays."""
    _, data = scene
    cfg, lcfg = head_cfg(data), lip_cfg(data)
    from geneface_tpu_torch.tasks.radnerf import RADNeRFTask

    task = RADNeRFTask(cfg, device="cpu", dtype=torch.float32)
    task.build()
    task.maybe_update_occ()  # step 0: the seeded sweep
    state = {"params": state_dict_to_flax(task.model.state_dict()),
             "occ": tuple(x.numpy() for x in task.occ)}
    jtasks = {"head": _jtask(cfg, data), "lip": _jtask(lcfg, data)}
    jlip = jtasks["lip"]
    jlip._build_lpips(jax.random.PRNGKey(5))
    batch = jtasks["head"].train_ds[2]
    jlip.train_ds.finetune_lip_flag = True
    lip_batch = jlip.train_ds[3]
    lip_rays = jlip._expand_light_batch(jlip._device_batch(lip_batch, STEP))
    lip_rays = tuple(np.asarray(lip_rays[k]) for k in ("rays_o", "rays_d"))
    rng = jax.random.PRNGKey(3)
    noises = {k: np.asarray(jax.random.uniform(rng, (len(b["inds"]),)))
              for k, b in (("head", batch), ("lip", lip_batch))}
    lpips = {k: np.asarray(v) for k, v in lpips_state_dict(jlip.lpips_params).items()}
    return dict(cfg=cfg, lcfg=lcfg, state=state, jtasks=jtasks, rng=rng, batch=batch,
                lip_batch=lip_batch, lip_rays=lip_rays, noises=noises, lpips=lpips)


@pytest.fixture(scope="module")
def ranks(scene, jax_case):
    """One two-rank run of every case; rank 0's and rank 1's results."""
    root, data = scene
    c = jax_case
    cfg, lcfg = c["cfg"], c["lcfg"]
    ds = RADNeRFDataset("train", data, dict(lcfg, native_loader=False), training=True)
    normal = [ds[2], ds[5]]
    ds.finetune_lip_flag = True
    lip = ds[3]
    cases = {
        "head_steps": dict(kind="head", cfg=cfg, batches=normal, task_step=0),
        "lip_steps": dict(kind="lip", cfg=lcfg, batches=[normal[0], lip], task_step=4),
        "head_grads": dict(kind="head", cfg=cfg, batch=c["batch"], state=c["state"],
                           noises=c["noises"]["head"], step=STEP, fn="grads"),
        "lip_grads": dict(kind="lip", cfg=lcfg, batch=c["lip_batch"], state=c["state"],
                          noises=c["noises"]["lip"], step=STEP, rays=c["lip_rays"],
                          lpips=c["lpips"], fn="grads"),
    }
    out = ddp.run_ranks("steps", {"cases": cases}, 2, str(root / "ranks"))
    for case in cases.values():
        case.pop("fn", None)
    return cases, out


def _check_grads(got: dict, want: dict, bound: float):
    assert set(got) == set(want)
    for name, g in want.items():
        assert rel_l2(got[name], g) <= bound, (name, rel_l2(got[name], g))


@pytest.mark.parametrize("case", ["head_steps", "lip_steps"])
def test_two_rank_steps_match_one_rank(ranks, case, monkeypatch):
    cases, out = ranks
    kept = []
    real = trenderer.waterfill_valid

    def spy(valid, capacity, group=None):
        keep = real(valid, capacity, group)
        kept.append((int(valid.sum()), int(keep.sum())))
        return keep

    monkeypatch.setattr(trenderer, "waterfill_valid", spy)
    one = ddp.step_result(**cases[case])
    two = out[0][case]
    for s, (l1, l2) in enumerate(zip(one["losses"], two["losses"])):
        for k in ("total_loss", "mse_loss", "weights_entropy_loss", "mean_samples"):
            np.testing.assert_allclose(l2[k], l1[k], rtol=1e-6, err_msg=f"{k} @ {s}")
        assert l2["march_span"] == l1["march_span"]
        _check_grads(two["grads"][s], one["grads"][s], 1e-5)
        # both ranks applied the same averaged gradient
        _check_grads(out[1][case]["grads"][s], two["grads"][s], 0.0)
    for a, b, c in zip(two["occ"], out[1][case]["occ"], one["occ"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    if case == "head_steps":
        assert kept and all(k < v for v, k in kept)  # the budget binds
        assert one["losses"][0]["occupancy_sweep"] == 1.0
    else:
        assert "lpips_loss" in two["losses"][1] and "lpips_loss" not in two["losses"][0]


@pytest.mark.parametrize("case", ["head_grads", "lip_grads"])
def test_two_rank_loss_matches_one_rank_and_jax_mesh(ranks, jax_case, case):
    cases, out = ranks
    c = jax_case
    lip = case == "lip_grads"
    two = out[0][case]
    one = ddp.loss_grads(**cases[case])
    np.testing.assert_allclose(two["losses"]["total_loss"], one["losses"]["total_loss"],
                               rtol=1e-6)
    _check_grads(two["grads"], one["grads"], 1e-5)

    jtask = c["jtasks"]["lip" if lip else "head"]
    params = jax.tree_util.tree_map(jnp.asarray, c["state"]["params"])
    occ = JOcc(*map(jnp.asarray, c["state"]["occ"]))
    jbatch = jtask._device_batch(c["lip_batch"] if lip else c["batch"], STEP)
    assert len(jbatch["inds"].sharding.device_set) == 2  # the rays are split
    if lip:
        jbatch = jtask._expand_light_batch(jbatch)
        del jbatch["inds"]  # the loss keeps these rays
    (jl, jls), jg = jax.jit(jax.value_and_grad(
        lambda p: jtask._loss_fn(p, occ, jbatch, c["rng"], train=True, lip=lip), has_aux=True,
    ))(params)
    assert float(jls["mean_samples"]) > 1.0
    assert two["losses"]["mean_samples"] == pytest.approx(float(jls["mean_samples"]), rel=1e-6)
    np.testing.assert_allclose(two["losses"]["total_loss"], float(jl), rtol=1e-5)
    if lip:
        np.testing.assert_allclose(two["losses"]["lpips_loss"], float(jls["lpips_loss"]),
                                   rtol=1e-5)
    for name, want in flax_to_state_dict(jg).items():
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert scale > 0, name
        np.testing.assert_allclose(two["grads"][name], want, rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)


def test_two_rank_fit_keeps_the_ranks_identical(scene, tmp_path):
    """``Trainer.fit`` on two ranks: the ranks end bit-identical, rank 0
    alone wrote the work dir (one metrics line per step and prefix), and
    the result stays near the one-rank run."""
    _, data = scene
    over = dict(max_updates=5, val_check_interval=5, tb_log_interval=1)
    work = str(tmp_path / "two")
    r0, r1 = ddp.run_ranks("fit", {"cfg": head_cfg(data, work, **over)}, 2,
                           str(tmp_path / "ranks"))
    one = ddp.job_fit({"cfg": head_cfg(data, str(tmp_path / "one"), **over)})
    assert r0["mesh"] == 2 and one["mesh"] == 1 and r0["step"] == r1["step"] == 5
    for name, p in one["params"].items():
        np.testing.assert_array_equal(r0["params"][name], r1["params"][name], err_msg=name)
        assert rel_l2(r0["params"][name], p) < 1e-3, name
    for a, b in zip(r0["occ"], r1["occ"]):
        np.testing.assert_array_equal(a, b)
    lines = [json.loads(x) for x in open(os.path.join(work, "metrics.jsonl"))]
    keys = [(x["step"], tuple(sorted(k for k in x if k != "ts"))) for x in lines]
    assert len(keys) == len(set(keys)) and len(lines) >= 5
    assert sorted(f for f in os.listdir(work) if f.endswith(".ckpt")) == [
        "model_ckpt_best.ckpt", "model_ckpt_steps_5.ckpt"]
