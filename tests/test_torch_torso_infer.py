"""The head+torso frame: a JAX-written torso checkpoint rendered by the
port's ``RADNeRFInfer`` on the CPU against the JAX ``RADNeRFInfer``.

Tolerances: at float32 the frame matches per pixel to 1e-5 absolute (the
head's samples and weights are the same; sums run in another order, and
the torso's MLPs and grid add a few float32 roundings). At the bf16 head
default a hidden unit of the head can round the other way on one side, so
the frame is held to 1e-3 absolute per pixel and 1e-5 in the mean. The
torso occupancy mask is exactly the JAX one (the planted grid keeps every
sample away from the threshold).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneface_tpu.config import Config as JConfig
from geneface_tpu.data.radnerf_dataset import get_cond_window as jget_cond_window
from geneface_tpu.inference.radnerf_infer import RADNeRFInfer as JInfer
from geneface_tpu.models.radnerf import RADNeRFTorso as JTorso
from geneface_tpu.models.radnerf.renderer import OccupancyState as JOcc
from geneface_tpu.models.radnerf.renderer import TorsoOccupancyState as JTorsoOcc
from geneface_tpu.models.radnerf.renderer import torso_occupancy_mask as jmask
from geneface_tpu.tasks.radnerf import model_from_cfg as jmodel_from_cfg
from geneface_tpu.utils.checkpoint import save_checkpoint as jsave
from geneface_tpu_torch.inference import RADNeRFInfer
from geneface_tpu_torch.ops.scatter import LAUNCHES

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.make_synthetic_dataset import make_dataset  # noqa: E402

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)

HW = 64


def _cfg(data_dir, work_dir):
    return dict(
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


def planted_torso_occupancy(H):
    """Alpha 0.5 over the lower half of the screen (x > 0, rows of the
    ``[y, x]`` grid's second axis), 0 elsewhere."""
    g = np.zeros((H, H), np.float32)
    g[:, H // 2 + 1:] = 0.5
    return g.reshape(-1), np.float32(g.mean())


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A JAX-initialised torso model, an occupancy ball and a planted torso
    grid, written by the JAX package."""
    root = tmp_path_factory.mktemp("torch_torso_infer")
    data = str(root / "data")
    make_dataset(data, n_frames=4, hw=HW)
    work = str(root / "work")
    cfg = _cfg(data, work)
    jmodel = jmodel_from_cfg(JConfig(cfg), JTorso, dtype=jnp.float32, torso_head_aware=True)
    params = jax.jit(lambda key: jmodel.init(
        key, jnp.zeros((3, 1, 204)), jnp.zeros((8, 3)), jnp.zeros((8, 3)),
        method=jmodel.init_all,
    ))(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.array, params)
    # a sigma head dense enough to composite visibly, a torso that shows
    params["params"]["sigma_net"]["Dense_1"]["kernel"][:, 0] += 0.5
    params["params"]["torso_canonical_net"]["Dense_2"]["kernel"][:, 0] += 1.0
    H = cfg["grid_size"]
    r = (np.arange(H) + 0.5) / H * 2.0 - 1.0
    gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
    occ = np.sqrt(gx**2 + gy**2 + gz**2) < 0.5
    dens = np.where(occ, 40.0, 0.0).reshape(1, -1).astype(np.float32)
    state = {
        "params": params,
        "occ": JOcc(jnp.asarray(dens), jnp.asarray(occ[None]), jnp.asarray(0.0)),
        "torso_occ": JTorsoOcc(*[jnp.asarray(x) for x in planted_torso_occupancy(H)]),
    }
    jsave(os.path.join(work, "model_ckpt_steps_0.ckpt"), {"state": state, "step": 0})
    jinf = JInfer(JConfig(cfg))
    assert jinf.torso
    return cfg, jinf


def _jax_frame(jinf, cfg, i, cap, mask):
    ds = jinf.dataset
    item = ds[i]
    return np.asarray(jinf._render_jit(
        jinf.params, (jinf.occ, jinf.torso_occ), jnp.asarray(item["rays_o"]),
        jnp.asarray(item["rays_d"]), jnp.asarray(item["bg_img"]),
        jnp.asarray(item["bg_coords"]),
        jnp.asarray(jget_cond_window(ds.conds, i, cfg["smo_win_size"])),
        jnp.asarray(item["pose"]), 0, ray_capacity=cap, cull_kdop=jinf._cull_kdop,
        torso_mask=mask,
    ))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_torso_frame_matches_jax_infer(scene, dtype):
    cfg, jinf0 = scene
    jinf = JInfer(JConfig(cfg))
    if dtype == "f32":  # the JAX driver's head MLPs at float32
        jinf.model = jmodel_from_cfg(JConfig(cfg), JTorso, dtype=jnp.float32,
                                     torso_head_aware=True)
        jinf._render_jit = jax.jit(jinf._render_frame, static_argnames=("ray_capacity",))
    cap = jinf._pick_ray_capacity()
    ds = jinf.dataset
    mask = jmask(jinf.torso_occ, jnp.asarray(ds.bg_coords), cfg["grid_size"], 0.01)
    inf = RADNeRFInfer(cfg, device="cpu",
                       dtype=torch.float32 if dtype == "f32" else torch.bfloat16)
    assert inf.torso
    before = dict(LAUNCHES)
    frames = inf.render_frames(2)
    assert LAUNCHES == before  # the CPU runs the plain versions
    assert frames.shape == (2, HW, HW, 3) and frames.dtype == np.uint8
    assert inf.ray_capacity == cap
    np.testing.assert_array_equal(inf.torso_mask.numpy(), np.asarray(mask))
    assert 0 < int(inf.torso_mask.sum()) < HW * HW
    for i in range(2):
        want = _jax_frame(jinf, cfg, i, cap, mask)
        out = inf.render_frame(i)
        got = out["rgb_map"].numpy()
        bg = ds[i]["bg_img"]
        ws = out["weights_sum"].numpy()
        torso_px = inf.torso_mask.numpy()
        head, torso, empty = ws > 0.5, torso_px & (ws < 1e-3), ~torso_px & (ws == 0)
        assert head.any() and torso.any() and empty.any()
        # the head and the torso both show; elsewhere the plain background
        assert np.abs(got - bg)[head].max() > 0.05 and np.abs(got - bg)[torso].max() > 0.05
        np.testing.assert_array_equal(got[empty], bg[empty])
        err = np.abs(got - want)
        if dtype == "f32":
            assert err.max() <= 1e-5, err.max()
        else:
            assert err.max() <= 1e-3 and err.mean() <= 1e-5, (err.max(), err.mean())
        want_u8 = (np.clip(got, 0, 1) * 255).astype(np.uint8).reshape(HW, HW, 3)
        np.testing.assert_array_equal(frames[i], want_u8)
