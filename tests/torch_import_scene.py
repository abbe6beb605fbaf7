"""A GeneFace checkpoint for the port's import tests: the keys of
``egs/datasets/videos/May/lm3d_radnerf_import.yaml`` at small widths, a
reference-format torso checkpoint authored from seeded numpy, and the JAX
importer's checkpoint of it (not a test module: the import tests share it).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

from geneface_tpu.models.radnerf.renderer import TorsoOccupancyState as JTorsoOcc
from geneface_tpu.utils import torch_import as jti
from geneface_tpu.utils.checkpoint import save_checkpoint as jsave
from geneface_tpu_torch.convert import state_dict_to_flax
from geneface_tpu_torch.models.radnerf import model_from_cfg
from geneface_tpu_torch.utils import torch_import as ti

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools.make_synthetic_dataset import make_dataset  # noqa: E402

STEP = 120
#: the occupied ball: small enough that a 96² frame culls rays
RADIUS = 0.4
IMPORT = dict(grid_num_levels=16, grid_level_dim=2, grid_backend="reference",
              march_backend="walk", mean_samples_per_ray=0)
TORSO = dict(torso_shrink=0.8, torso_individual_embedding_dim=8, torso_head_aware=False)


def import_cfg(data_dir, work_dir, **over):
    cfg = dict(
        data_dir=data_dir, work_dir=work_dir,
        cond_type="idexp_lm3d_normalized", cond_win_size=1, smo_win_size=3,
        cond_out_dim=16, with_att=True, bound=1, grid_type="tiledgrid",
        log2_hashmap_size=14, desired_resolution=128, grid_size=32,
        num_layers_ambient=2, hidden_dim_ambient=16, num_layers_sigma=2,
        hidden_dim_sigma=16, geo_feat_dim=16, num_layers_color=2,
        hidden_dim_color=16, individual_embedding_num=16, individual_embedding_dim=4,
        max_steps=8, min_near=0.05, dt_gamma=1.0 / 256, density_thresh=10, seed=0,
        n_rays=256, near=0.3, far=0.9, lr=5e-3, scheduler="exponential",
        update_extra_interval=100, finetune_lips=False, lambda_weights_entropy=1e-4,
        lambda_ambient=0.1, native_loader=False, **TORSO, **IMPORT,
    )
    cfg.update(over)
    return cfg


def author_geneface_checkpoint(path, cfg, seed=0):
    """A GeneFace torso checkpoint: seeded weights, grids spread to ±0.05
    (500× the init's; at ±0.5 the ambient grid's slope, up to 128 × the
    spread per unit, turns float32 rounding of its input into 1.4e-6 on 3
    pixels of a head frame), a sigma head that makes the occupied ball composite, a torso that
    shows, the density grid of a ball of radius ``RADIUS`` and a torso grid over
    the lower half of the screen."""
    model = model_from_cfg(cfg, torso=True)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    sd = ti.reference_state_dict(model)
    rng = np.random.RandomState(seed)
    for k in sd:
        if k.endswith("embedder.embeddings"):
            sd[k] = rng.uniform(-0.05, 0.05, sd[k].shape).astype(np.float32)
    last = cfg["num_layers_sigma"] - 1
    sd[f"sigma_net.net.{last}.weight"][0] += 0.5
    sd["torso_canonicial_net.net.2.weight"][0] += 1.0
    H = cfg["grid_size"]
    r = (np.arange(H) + 0.5) / H * 2.0 - 1.0
    gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
    sd["density_grid"] = np.where(np.sqrt(gx**2 + gy**2 + gz**2) < RADIUS, 40.0, 0.0
                                  ).reshape(-1).astype(np.float32)
    tg = np.zeros((H, H), np.float32)
    tg[:, H // 2 + 1:] = 0.5
    sd["density_grid_torso"] = tg.reshape(-1)
    os.makedirs(path, exist_ok=True)
    torch.save({"state_dict": {"model": {k: torch.from_numpy(v) for k, v in sd.items()}}},
               os.path.join(path, f"model_ckpt_steps_{STEP}.ckpt"))
    return sd


def jax_checkpoint(work, cfg, sd, torso, template=None):
    """The JAX importer's checkpoint of ``sd`` (JAX layout, JAX-written) on
    ``template``: by default the port's flax-layout tree of the config's
    model, which ``tests/test_torch_import.py`` holds equal to the JAX
    model's ``init`` (and which takes no JAX trace to build)."""
    if template is None:
        template = state_dict_to_flax(model_from_cfg(cfg, torso=torso).state_dict())
    state = {"params": jti.radnerf_params_from_torch(sd, template),
             "occ": jti.occupancy_from_torch(sd, cfg["grid_size"], cfg["density_thresh"])}
    if torso:
        tg = jti.torso_density_grid_from_torch(sd, cfg["grid_size"]).reshape(-1)
        state["torso_occ"] = JTorsoOcc(jnp.asarray(tg), jnp.asarray(tg.mean(), jnp.float32))
    jsave(os.path.join(work, f"model_ckpt_steps_{STEP}.ckpt"), {"state": state, "step": STEP})
    return state


def make_scene(root, hw):
    """The synthetic dataset (6 frames of ``hw``²), the config and the
    authored GeneFace checkpoint under ``root``."""
    data = str(root / "data")
    make_dataset(data, n_frames=6, hw=hw)
    cfg = import_cfg(data, "")
    src = str(root / "geneface")
    sd = author_geneface_checkpoint(src, cfg)
    return dict(root=root, data=data, src=src, sd=sd, cfg=cfg)
