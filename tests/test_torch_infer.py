"""The slice as a whole: a JAX-written checkpoint rendered by the port's
``RADNeRFInfer`` on the CPU against the JAX renderer.

Tolerances: at float32 the frame matches per pixel to 1e-6 absolute (the
same samples, the same weights; only summation order differs). At the bf16
default a hidden unit can round the other way on one side, so the frame is
held to 1e-3 absolute per pixel and 1e-6 in the mean. An empty occupancy
grid renders exactly the background.
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
from geneface_tpu.models.radnerf import RADNeRF as JRADNeRF
from geneface_tpu.models.radnerf.renderer import OccupancyState as JOcc
from geneface_tpu.models.radnerf.renderer import occupied_kdop as joccupied_kdop
from geneface_tpu.models.radnerf.renderer import render_rays_radnerf as jrender
from geneface_tpu.tasks.radnerf import model_from_cfg as jmodel_from_cfg
from geneface_tpu.utils.checkpoint import save_checkpoint as jsave
from geneface_tpu_torch.inference import RADNeRFInfer
from geneface_tpu_torch.ops.scatter import LAUNCHES

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.make_synthetic_dataset import make_dataset  # noqa: E402

HW = 96


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
        mean_samples_per_ray=8, seed=0,
    )


def _write_checkpoint(work_dir, cfg, radius):
    """JAX-initialized params + a planted occupancy ball, JAX-written."""
    jmodel = jmodel_from_cfg(JConfig(cfg), JRADNeRF, dtype=jnp.float32)
    params = jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((3, 1, 204)), jnp.zeros((8, 3)),
        jnp.zeros((8, 3)), method=jmodel.init_all,
    )
    # a sigma head that makes the ball dense enough to composite visibly
    sig = params["params"]["sigma_net"]["Dense_1"]["kernel"]
    params["params"]["sigma_net"]["Dense_1"]["kernel"] = sig.at[:, 0].add(0.5)
    H = cfg["grid_size"]
    r = (np.arange(H) + 0.5) / H * 2.0 - 1.0
    gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
    occ = np.sqrt(gx**2 + gy**2 + gz**2) < radius
    dens = np.where(occ, 40.0, 0.0).reshape(1, -1).astype(np.float32)
    state = {"params": params,
             "occ": JOcc(jnp.asarray(dens), jnp.asarray(occ[None]), jnp.asarray(0.0))}
    jsave(os.path.join(work_dir, "model_ckpt_steps_0.ckpt"), {"state": state, "step": 0})
    return jmodel, params, state["occ"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_infer")
    data = str(root / "data")
    make_dataset(data, n_frames=6, hw=HW)
    work = str(root / "work")
    cfg = _cfg(data, work)
    jmodel, params, occ = _write_checkpoint(work, cfg, radius=0.6)
    return cfg, jmodel, params, occ


def test_frame_matches_jax_render_f32(scene):
    cfg, jmodel, params, occ = scene
    inf = RADNeRFInfer(cfg, device="cpu", dtype=torch.float32)
    inf.prepare()
    assert inf.ray_capacity is not None and inf.ray_capacity < HW * HW
    i = 1
    out = inf.render_frame(i)
    n = out["n_samples"].numpy()
    assert n.sum() > 1000 and n.max() <= cfg["max_steps"]

    ds = inf.dataset
    item = ds[i]
    cond = jnp.asarray(jget_cond_window(ds.conds, i, cfg["smo_win_size"]))
    feat = jmodel.apply(params, cond, method=jmodel.cal_cond_feat)
    ind = params["params"]["individual_embeddings"][0]
    ref = jrender(
        lambda x, d: jmodel.apply(params, x, d, feat, ind),
        jnp.asarray(item["rays_o"]), jnp.asarray(item["rays_d"]), occ,
        bound=1.0, min_near=0.05, dt_gamma=1 / 256, max_steps=cfg["max_steps"],
        grid_size=cfg["grid_size"], bg_color=jnp.asarray(item["bg_torso_img"]),
        mean_samples_per_ray=8.0, ray_capacity=inf.ray_capacity,
        lattice_K=48, cull_kdop=joccupied_kdop(occ.occ_grid, 1.0),
    )
    got = out["rgb_map"].numpy()
    want = np.asarray(ref["rgb_map"])
    assert np.abs(want - item["bg_torso_img"]).max() > 0.05  # the head shows
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        out["weights_sum"].numpy(), np.asarray(ref["weights_sum"]), rtol=0, atol=1e-6
    )
    np.testing.assert_allclose(
        out["depth_map"].numpy(), np.asarray(ref["depth_map"]), rtol=0, atol=1e-6
    )


def test_frames_match_jax_infer_bf16(scene):
    cfg, _, _, _ = scene
    jinf = JInfer(JConfig(cfg))
    cap = jinf._pick_ray_capacity()
    inf = RADNeRFInfer(cfg, device="cpu")  # bf16 MLPs, the default
    frames = inf.render_frames(2)
    assert frames.shape == (2, HW, HW, 3) and frames.dtype == np.uint8
    assert inf.ray_capacity == cap
    ds = jinf.dataset
    for i in range(2):
        item = ds[i]
        ref = np.asarray(jinf._render_jit(
            jinf.params, (jinf.occ,), jnp.asarray(item["rays_o"]),
            jnp.asarray(item["rays_d"]), jnp.asarray(item["bg_torso_img"]),
            jnp.asarray(item["bg_coords"]),
            jnp.asarray(jget_cond_window(ds.conds, i, cfg["smo_win_size"])),
            jnp.asarray(item["pose"]), 0, ray_capacity=cap,
            cull_kdop=jinf._cull_kdop,
        ))
        got = inf.render_frame(i)["rgb_map"].numpy()
        err = np.abs(got - ref)
        assert err.max() <= 1e-3 and err.mean() <= 1e-6, (err.max(), err.mean())
        want_u8 = (np.clip(got, 0, 1) * 255).astype(np.uint8).reshape(HW, HW, 3)
        np.testing.assert_array_equal(frames[i], want_u8)


def test_empty_occupancy_renders_background(tmp_path, scene):
    cfg0, _, _, _ = scene
    work = str(tmp_path / "work_empty")
    cfg = {**cfg0, "work_dir": work}
    _write_checkpoint(work, cfg, radius=0.0)
    inf = RADNeRFInfer(cfg, device="cpu", dtype=torch.float32)
    inf.prepare()
    out = inf.render_frame(0)
    np.testing.assert_array_equal(out["rgb_map"].numpy(), inf.dataset[0]["bg_torso_img"])
    assert float(out["weights_sum"].abs().max()) == 0.0


def test_cpu_render_launches_no_kernel(scene):
    cfg, _, _, _ = scene
    before = LAUNCHES["scatter_add_rows"]
    RADNeRFInfer(cfg, device="cpu", dtype=torch.float32).render_frames(1)
    assert LAUNCHES["scatter_add_rows"] == before


def test_cuda_without_card_raises(scene):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg, _, _, _ = scene
    with pytest.raises(RuntimeError, match="CUDA"):
        RADNeRFInfer(cfg)  # defaults to the card


def test_conds_from_lm3d_matches_jax(scene):
    cfg0, _, _, _ = scene
    cfg = {**cfg0, "infer_lm3d_smooth_sigma": 1.5, "infer_lm3d_clamp_std": 2.0}
    jinf = JInfer(JConfig(cfg))
    inf = RADNeRFInfer(cfg, device="cpu", dtype=torch.float32)
    rng = np.random.RandomState(4)
    mean = np.asarray(jinf.dataset.idexp_lm3d_mean)
    lm = mean + rng.randn(9, 68, 3).astype(np.float32) * 0.05
    np.testing.assert_allclose(
        inf.conds_from_lm3d(lm), jinf.conds_from_lm3d(lm), rtol=1e-6, atol=1e-6
    )
    # with the LLE projection: 1e-4 (the synthetic database has rank 2, and
    # the JAX package's float32 Gram products round by as much as the LLE's
    # ridge; see tests/test_torch_audio_infer.py)
    lle_cfg = {**cfg, "infer_lm3d_lle_percent": 0.5}
    np.testing.assert_allclose(
        RADNeRFInfer(lle_cfg, device="cpu").conds_from_lm3d(lm),
        JInfer(JConfig(lle_cfg)).conds_from_lm3d(lm), rtol=0, atol=1e-4,
    )
