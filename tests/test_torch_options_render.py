"""Frames and the torso step under the options the port once refused,
against the JAX package: head+torso frames through ``RADNeRFInfer`` at
``grid_compute_dtype`` bf16 (with ``grid_bwd_dtype`` bf16) and mixed, and
at ``bound: 2`` (two cascades, the walk); one torso training step with its
grid at bf16.

Tolerances:
- frames, float32 MLPs against the JAX driver jitted: under the grid
  options max 1e-3 and mean 1e-5 per pixel (XLA's jitted program rounds a
  few grid features to the neighbouring bfloat16, see
  ``tests/test_torch_options.py``); at ``bound: 2``, whose grids are
  float32, max 1e-5 (the float32 frame bound of
  ``tests/test_torch_torso_infer.py``);
- the torso step at ``grid_compute_dtype: bf16`` against the eager JAX
  gradient (jitted, XLA's CPU compiler puts the deform nets' gradients
  10-12% off, ``tests/test_torch_torso_training.py``): loss rel 1e-5, every
  torso parameter's gradient within a relative L2 error of 1e-3 (measured
  2.4e-4, the torso grid's hash group; float32 reads 1e-4), and the torso
  grid's gradients closer to JAX's bf16 ones than the port's float32 step
  is.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneface_tpu.config import Config as JConfig
from geneface_tpu.data.radnerf_dataset import RADNeRFDataset as JDataset
from geneface_tpu.data.radnerf_dataset import get_cond_window as jget_cond_window
from geneface_tpu.inference.radnerf_infer import RADNeRFInfer as JInfer
from geneface_tpu.models.radnerf import RADNeRFTorso as JTorso
from geneface_tpu.models.radnerf.renderer import OccupancyState as JOcc
from geneface_tpu.models.radnerf.renderer import TorsoOccupancyState as JTorsoOcc
from geneface_tpu.models.radnerf.renderer import torso_occupancy_mask as jmask
from geneface_tpu.tasks.radnerf import model_from_cfg as jmodel_from_cfg
from geneface_tpu.tasks.radnerf_torso import RADNeRFTorsoTask as JTorsoTask
from geneface_tpu.utils.checkpoint import save_checkpoint as jsave
from geneface_tpu_torch.convert import flax_to_state_dict
from geneface_tpu_torch.inference import RADNeRFInfer
from geneface_tpu_torch.models.radnerf import OccupancyState, TorsoOccupancyState
from geneface_tpu_torch.tasks.radnerf_torso import RADNeRFTorsoTask

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.make_synthetic_dataset import make_dataset  # noqa: E402

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)

HW = 64


def _frame_cfg(data_dir, work_dir, **over):
    cfg = dict(
        data_dir=data_dir, work_dir=work_dir,
        cond_type="idexp_lm3d_normalized", cond_win_size=1, smo_win_size=3,
        cond_out_dim=16, with_att=True, bound=1, grid_type="tiledgrid",
        log2_hashmap_size=14, desired_resolution=128, grid_size=32,
        num_layers_ambient=2, hidden_dim_ambient=16, num_layers_sigma=2,
        hidden_dim_sigma=16, geo_feat_dim=16, num_layers_color=2,
        hidden_dim_color=16, individual_embedding_num=16,
        individual_embedding_dim=4, max_steps=8, min_near=0.05,
        mean_samples_per_ray=8, seed=0, torso_head_aware=True,
    )
    cfg.update(over)
    return cfg


def _planted(H, C):
    r = (np.arange(H) + 0.5) / H * 2.0 - 1.0
    gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
    occ = np.repeat((np.sqrt(gx**2 + gy**2 + gz**2) < 0.5)[None], C, axis=0)
    return np.where(occ, 40.0, 0.0).reshape(C, -1).astype(np.float32), occ


@pytest.fixture(scope="module")
def torso_scene(tmp_path_factory):
    """A JAX-initialised torso model (the head included), an occupancy ball
    in every cascade and a planted torso grid, written by the JAX package
    for ``bound`` 1 and 2 → (data dir, work dir by bound, the parameters)."""
    root = tmp_path_factory.mktemp("torch_options")
    data = str(root / "data")
    make_dataset(data, n_frames=4, hw=HW)
    cfg = _frame_cfg(data, "")
    jmodel = jmodel_from_cfg(JConfig(cfg), JTorso, dtype=jnp.float32, torso_head_aware=True)
    params = jax.jit(lambda key: jmodel.init(
        key, jnp.zeros((3, 1, 204)), jnp.zeros((8, 3)), jnp.zeros((8, 3)),
        method=jmodel.init_all,
    ))(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.array, params)
    params["params"]["sigma_net"]["Dense_1"]["kernel"][:, 0] += 0.5
    params["params"]["torso_canonical_net"]["Dense_2"]["kernel"][:, 0] += 1.0
    H = cfg["grid_size"]
    g = np.zeros((H, H), np.float32)
    g[:, H // 2 + 1:] = 0.5
    works = {}
    for bound in (1, 2):
        dens, occ = _planted(H, bound)
        works[bound] = str(root / f"work_b{bound}")
        state = {"params": params,
                 "occ": JOcc(jnp.asarray(dens), jnp.asarray(occ), jnp.asarray(0.0)),
                 "torso_occ": JTorsoOcc(jnp.asarray(g.reshape(-1)), jnp.asarray(g.mean()))}
        jsave(os.path.join(works[bound], "model_ckpt_steps_0.ckpt"), {"state": state, "step": 0})
    return data, works, params


def _jax_frames(cfg, n):
    """The JAX driver's head+torso frames at float32 MLPs (jitted)."""
    jinf = JInfer(JConfig(cfg))
    jinf.model = jmodel_from_cfg(JConfig(cfg), JTorso, dtype=jnp.float32, torso_head_aware=True)
    jinf._render_jit = jax.jit(jinf._render_frame, static_argnames=("ray_capacity",))
    cap = jinf._pick_ray_capacity()
    ds = jinf.dataset
    mask = jmask(jinf.torso_occ, jnp.asarray(ds.bg_coords), cfg["grid_size"], 0.01)
    frames = []
    for i in range(n):
        item = ds[i]
        frames.append(np.asarray(jinf._render_jit(
            jinf.params, (jinf.occ, jinf.torso_occ), jnp.asarray(item["rays_o"]),
            jnp.asarray(item["rays_d"]), jnp.asarray(item["bg_img"]),
            jnp.asarray(item["bg_coords"]),
            jnp.asarray(jget_cond_window(ds.conds, i, cfg["smo_win_size"])),
            jnp.asarray(item["pose"]), 0, ray_capacity=cap, cull_kdop=jinf._cull_kdop,
            torso_mask=mask,
        )))
    return frames, cap


@pytest.mark.parametrize("opts,bound", [
    ({"grid_compute_dtype": "bf16", "grid_bwd_dtype": "bf16"}, 1),
    ({"grid_compute_dtype": "mixed"}, 1),
    ({}, 2),
])
def test_frames_under_the_options_match_jax_infer(torso_scene, opts, bound):
    data, works, _ = torso_scene
    cfg = _frame_cfg(data, works[bound], bound=bound, **opts)
    want, cap = _jax_frames(cfg, 2)
    inf = RADNeRFInfer(cfg, device="cpu", dtype=torch.float32)
    inf.prepare()
    assert inf.torso
    meta = inf.model.pos_fused_meta
    assert (meta.compute, meta.bwd_compute) == (opts.get("grid_compute_dtype", "f32"),
                                                opts.get("grid_bwd_dtype", "same"))
    assert inf.model.torso_fused_meta.compute == meta.compute
    assert inf.occ_grid.shape[0] == bound
    for i in range(2):
        out = inf.render_frame(i)
        got = out["rgb_map"].numpy()
        ws = out["weights_sum"].numpy()
        assert (ws > 0.5).any()  # the head shows
        err = np.abs(got - want[i])
        if opts:
            assert err.max() <= 1e-3 and err.mean() <= 1e-5, (err.max(), err.mean())
        else:
            assert err.max() <= 1e-5, err.max()
    assert inf.ray_capacity == cap
    if bound == 2:  # the walk's samples reach the outer cascade's step
        assert float(out["n_samples"].float().mean()) > 0


# ------------------------------------------------------------ torso step --
def test_torso_step_at_bf16_grid_matches_eager_jax(torso_scene):
    data, _, params = torso_scene
    cfg = _frame_cfg(data, "", grid_compute_dtype="bf16", n_rays=256, lr=5e-3,
                     scheduler="exponential", max_updates=4, update_extra_interval=4,
                     lambda_weights_entropy=1e-4, density_thresh_torso=0.01,
                     native_loader=False)
    jtask = JTorsoTask(JConfig(cfg))  # the parts of build() that the loss reads
    jtask.model = jmodel_from_cfg(JConfig(cfg), JTorso, dtype=jnp.float32, torso_head_aware=True)
    jtask.train_ds = JDataset("train", data, JConfig(cfg), training=True)
    jtask.grid_size = H = cfg["grid_size"]
    dens, occ = _planted(H, 1)
    jocc = JOcc(jnp.asarray(dens), jnp.asarray(occ), jnp.asarray(0.0))
    g = np.zeros((H, H), np.float32)
    g[:, H // 2 + 1:] = 0.5
    torso_occ = (g.reshape(-1), np.float32(g.mean()))
    batch = jtask.train_ds[2]
    dbatch = jtask._device_batch(batch, 0)
    dbatch["pose"] = jnp.asarray(batch["pose"])
    rng = jax.random.PRNGKey(3)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jtask._loss_fn_torso(p, jocc, JTorsoOcc(*map(jnp.asarray, torso_occ)),
                                       dbatch, rng, True),
        has_aux=True,
    )(params)
    jgrads = flax_to_state_dict(jgrads)
    noises = torch.from_numpy(np.array(jax.random.uniform(rng, (len(batch["inds"]),))))

    def port_step(compute):
        task = RADNeRFTorsoTask(dict(cfg, grid_compute_dtype=compute), device="cpu",
                                dtype=torch.float32)
        task.build()
        task.model.load_state_dict(
            {k: torch.from_numpy(v) for k, v in flax_to_state_dict(params).items()})
        task.set_occupancy(OccupancyState(torch.from_numpy(dens), torch.from_numpy(occ),
                                          torch.zeros(())))
        task.torso_occ = TorsoOccupancyState(*[torch.from_numpy(np.array(x)) for x in torso_occ])
        assert task.model.torso_fused_meta.compute == compute
        loss, _ = task.loss_fn(task.device_batch(batch, 0), noises, train=True)
        loss.backward()
        return float(loss.detach()), {n: p.grad.numpy() for n, p in task.model.named_parameters()
                             if p.grad is not None}

    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    loss, grads = port_step("bf16")
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    assert len(grads) == 15  # grid x2, codes, deform x3, canonical x3, head-aware x6
    for name, got in grads.items():
        assert rel(got, jgrads[name]) <= 1e-3, (name, rel(got, jgrads[name]))
    _, grads32 = port_step("f32")
    for name in ("torso_embeddings.group_0", "torso_embeddings.group_1"):
        assert rel(grads[name], jgrads[name]) < rel(grads32[name], jgrads[name]), name
