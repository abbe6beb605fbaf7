"""The scene every cell runs: the configuration, a fixed synthetic person
(a 100-frame 512² dataset, made once per checkout), the weights from the
run's seed (made on the card), the planted occupancy that stands for a
trained grid, and the checkpoint the serving entry points load.

The weights are the benchmark's, keyed by the program's parameter names and
shaped from the configuration by :mod:`reference.radnerf`'s layout: the
program loads them through its own checkpoint reader and the reference reads
the same tensors.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from reference import radnerf as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".cache")


def load_json(*parts) -> dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def config(name: str) -> dict:
    """``configs/<name>.json``: the run configuration under ``config``."""
    return dict(load_json("configs", f"{name}.json")["config"])


def program_seed(seed: int) -> int:
    """The program's own ``seed`` key: its numpy streams take 32 bits."""
    return int(seed) % (2**31 - 16)


def dataset_dir(cfg: dict) -> str:
    """The person's dataset, made once per checkout at a fixed path (the
    same frames for every seed: the seed draws the weights and the traffic)."""
    n, hw = int(cfg["dataset_frames"]), int(cfg["dataset_hw"])
    out = os.path.join(CACHE, f"person_{n}x{hw}")
    if not os.path.exists(os.path.join(out, "trainval_dataset.npy")):
        from geneface_tpu_torch.tools.make_synthetic_dataset import make_dataset

        part = f"{out}.part{os.getpid()}"
        make_dataset(part, n_frames=n, hw=hw, seed=0)
        try:
            os.rename(part, out)
        except OSError:  # another run made it first
            import shutil

            shutil.rmtree(part, ignore_errors=True)
    return out


def read_dataset(cfg: dict) -> dict:
    return np.load(os.path.join(dataset_dir(cfg), "trainval_dataset.npy"),
                   allow_pickle=True).tolist()


def param_specs(cfg: dict, torso: bool) -> list:
    """``(name, shape, init)`` of every parameter, from the configuration's
    widths; ``init`` is ``grid``, ``code``, ``bias`` or ``fan_in`` (a
    weight of that fan-in)."""
    pos, amb = ref.head_grids(cfg)
    specs = [("individual_embeddings", (int(cfg["individual_embedding_num"]),
                                        int(cfg["individual_embedding_dim"])), "code")]
    if torso:
        specs.append(("torso_individual_codes", (int(cfg["individual_embedding_num"]),
                                                 int(cfg["torso_individual_embedding_dim"])), "code"))
    for name, grid in (("pos_embeddings", pos), ("ambient_embeddings", amb)):
        specs += [(f"{name}.group_{gi}", grid.shape(gi), "grid") for gi in range(len(grid.groups))]
    cin = 204 * 1  # idexp lm3d, one frame a window
    for i, (a, b) in enumerate(zip((cin, 32, 32, 64), (32, 32, 64, 64))):
        specs += [(f"cond_prenet.convs.{i}.weight", (b, a, 3), "fan_in"),
                  (f"cond_prenet.convs.{i}.bias", (b,), "bias")]
    specs += [("cond_prenet.fc1.weight", (64, 64), "fan_in"), ("cond_prenet.fc1.bias", (64,), "bias"),
              ("cond_prenet.fc2.weight", (int(cfg["cond_out_dim"]), 64), "fan_in"),
              ("cond_prenet.fc2.bias", (int(cfg["cond_out_dim"]),), "bias")]
    for i, (a, b) in enumerate(zip((64, 16, 8, 4, 2), (16, 8, 4, 2, 1))):
        specs += [(f"cond_att_net.convs.{i}.weight", (b, a, 3), "fan_in"),
                  (f"cond_att_net.convs.{i}.bias", (b,), "bias")]
    smo = int(cfg["smo_win_size"])
    specs += [("cond_att_net.fc.weight", (smo, smo), "fan_in"), ("cond_att_net.fc.bias", (smo,), "bias")]
    LC = int(cfg["grid_num_levels"]) * int(cfg["grid_level_dim"])

    def mlp(name, dims):
        return [(f"{name}.layers.{i}.weight", (dims[i + 1], dims[i]), "fan_in")
                for i in range(len(dims) - 1)]

    def widths(din, dout, hidden, layers):
        return [din] + [hidden] * (layers - 1) + [dout]

    specs += mlp("ambient_net", widths(LC + int(cfg["cond_out_dim"]), 2,
                                       int(cfg["hidden_dim_ambient"]), int(cfg["num_layers_ambient"])))
    specs += mlp("sigma_net", widths(2 * LC, 1 + int(cfg["geo_feat_dim"]),
                                     int(cfg["hidden_dim_sigma"]), int(cfg["num_layers_sigma"])))
    specs += mlp("color_net", widths(16 + int(cfg["geo_feat_dim"]) + int(cfg["individual_embedding_dim"]),
                                     3, int(cfg["hidden_dim_color"]), int(cfg["num_layers_color"])))
    if torso:
        tg = ref.torso_grid(cfg)
        specs += [(f"torso_embeddings.group_{gi}", tg.shape(gi), "grid") for gi in range(len(tg.groups))]
        h = 2 * 21 + 6 * 9 + int(cfg["torso_individual_embedding_dim"])
        specs += mlp("torso_deform_net", [h, 64, 64, 2])
        specs += mlp("torso_canonical_net", [LC + h, 32, 32, 4])
    return specs


def make_weights(cfg: dict, seed: int, device, torso: bool) -> dict:
    """The parameters from ``seed`` on ``device``, float32: two draws from a
    generator on the device (one uniform, one normal), cut into the
    parameters. Grid tables U(-a, a) with ``a = cfg['grid_init_scale']``
    (a trained grid's magnitude), weights N(0, 1/fan_in), biases 0,
    codes 0.1·N(0, 1)."""
    specs = param_specs(cfg, torso)
    g = torch.Generator(device=device).manual_seed(int(seed))
    n_uni = sum(math.prod(s) for _, s, k in specs if k == "grid")
    n_norm = sum(math.prod(s) for _, s, k in specs if k in ("code", "fan_in"))
    uni = torch.rand(n_uni, generator=g, device=device)
    norm = torch.randn(n_norm, generator=g, device=device)
    a = float(cfg["grid_init_scale"])
    out, iu, inn = {}, 0, 0
    for name, shape, kind in specs:
        n = math.prod(shape)
        if kind == "grid":
            out[name] = ((uni[iu:iu + n] * 2 - 1) * a).reshape(shape)
            iu += n
        elif kind == "bias":
            out[name] = torch.zeros(shape, device=device)
        else:
            std = 0.1 if kind == "code" else math.sqrt(1.0 / math.prod(shape[1:]))
            out[name] = (norm[inn:inn + n] * std).reshape(shape)
            inn += n
    return out


def planted_occupancy(H: int, thresh: float, radius: float = 0.6) -> tuple:
    """A dense ball of occupied cells standing for a trained grid: density
    ``4·thresh`` inside, 0 outside, mean density 0 (density, occ, mean)."""
    r = (np.arange(H) + 0.5) / H * 2.0 - 1.0
    gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
    occ = np.sqrt(gx**2 + gy**2 + gz**2) < (radius + 4.0 / H)
    density = np.where(occ, 4.0 * thresh, 0.0).reshape(1, -1).astype(np.float32)
    return density, occ[None], np.float32(0.0)


def planted_torso_occupancy(H: int) -> tuple:
    """Alpha 0.5 over the lower half of the screen (x > 0; stored [y, x])."""
    g = np.zeros((H, H), np.float32)
    g[:, H // 2:] = 0.5
    return g.reshape(-1), np.float32(g.mean())


def run_cfg(cfg: dict, seed: int, work: str, data: str) -> dict:
    """The configuration as the program takes it for this run."""
    return dict(cfg, seed=program_seed(seed), work_dir=work, data_dir=data)


def write_checkpoint(work: str, P: dict, cfg: dict, torso: bool) -> None:
    """The serving checkpoint in the program's layout: the weights, the
    planted occupancy (and the torso's)."""
    from geneface_tpu_torch.convert import state_dict_to_flax
    from geneface_tpu_torch.utils.checkpoint import save_checkpoint

    sd = {k: v.detach().cpu().numpy() for k, v in P.items()}
    state = {"params": state_dict_to_flax(sd),
             "occ": planted_occupancy(int(cfg["grid_size"]), float(cfg["density_thresh"]))}
    if torso:
        state["torso_occ"] = planted_torso_occupancy(int(cfg["grid_size"]))
    save_checkpoint(os.path.join(work, "model_ckpt_steps_0.ckpt"), {"state": state, "step": 0})
