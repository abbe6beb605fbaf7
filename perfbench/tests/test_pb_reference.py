"""The plain reference against the port's CPU path at a small size: the
grids, the fields, both marches, the k-DOP and the optimizer step."""

import numpy as np
import pytest
import torch

from pbcore import scene
from reference import radnerf as ref


@pytest.fixture(scope="module")
def models():
    from geneface_tpu_torch.models.radnerf import model_from_cfg

    cfg = scene.config("radnerf_torso")
    P = scene.make_weights(cfg, 2**31 + 3, torch.device("cpu"), torso=True)
    model = model_from_cfg(cfg, torso=True)
    model.load_state_dict(P)
    return cfg, P, model


def _points(n, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, d, generator=g)


@pytest.mark.parametrize("which", ["pos", "ambient", "torso"])
def test_grid_encode(models, which):
    from geneface_tpu_torch.ops import fused_grid_encode

    cfg, P, model = models
    pos, amb = ref.head_grids(cfg)
    grid = {"pos": pos, "ambient": amb, "torso": ref.torso_grid(cfg)}[which]
    fmeta = getattr(model, f"{which}_fused_meta")
    tables = (model.grid_tables()[which] if which != "torso" else model.torso_grid_tables())
    x = _points(4096, grid.meta.input_dim) * 1.1 - 0.05  # some outside [0, 1]
    params = [P[f"{which}_embeddings.group_{i}"] for i in range(len(grid.groups))]
    mine = ref.grid_encode([x[:, d] for d in range(x.shape[1])], grid, ref.grid_views(grid, params))
    theirs = fused_grid_encode(x, tables, fmeta)
    assert torch.equal(mine, theirs)


def test_head_field(models):
    cfg, P, model = models
    head = ref.Head(cfg, P)
    xyz = _points(2048, 3, 1) * 2 - 1
    dirs = torch.nn.functional.normalize(_points(2048, 3, 2) - 0.5, dim=-1)
    cond = _points(5 * 204, 1, 3).reshape(5, 1, 204)
    code = P["individual_embeddings"][7]
    with torch.no_grad():
        cf_ref, cf = head.cond(cond), model.cal_cond_feat(cond)
        assert torch.allclose(cf_ref, cf, atol=1e-6)
        got = model(xyz, dirs, cf, code)
        want = head(xyz, dirs, cf, code, head.views())
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-6)


def test_torso_field(models):
    cfg, P, model = models
    tor = ref.Torso(cfg, P)
    xy = _points(2048, 2, 4) * 2 - 1
    pose6 = _points(1, 6, 5)
    code = P["torso_individual_codes"][3]
    with torch.no_grad():
        got = model.forward_torso(xy, pose6, code)
        want = tor(xy, pose6, code, tor.views())
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-6)


def _rays(n=4096):
    pose = ref.ngp_pose(np.array([[1, 0, 0, 0], [0, 1, 0, 0.02], [0, 0, 1, 0.6], [0, 0, 0, 1]],
                                 np.float32))
    o, d = ref.get_rays(pose, (120.0, 120.0, 64.0, 64.0), 128, 128)
    idx = np.random.RandomState(0).randint(0, len(o), n)
    return torch.as_tensor(o[idx]), torch.as_tensor(d[idx])


def test_marches():
    from geneface_tpu_torch.ops import march_rays_lattice, march_rays_train, near_far_from_aabb
    from geneface_tpu_torch.ops import occupied_cell_aabb, pack_occ_blocks

    H = 32
    occ0 = torch.as_tensor(scene.planted_occupancy(H, 10.0)[1][0])
    o, d = _rays()
    aabb = ref.make_aabb(1.0, "cpu")
    nears, fars = ref.near_far(o, d, aabb, 0.05)
    n2, f2 = near_far_from_aabb(o, d, aabb, 0.05)
    assert torch.equal(nears, n2) and torch.equal(fars, f2)
    noise = _points(o.shape[0], 1, 6)[:, 0]
    mine = ref.march_lattice(o, d, occ0, nears, fars, noise, bound=1.0, max_steps=16,
                             grid_size=H, lattice_K=32)
    theirs = march_rays_lattice(o, d, pack_occ_blocks(occ0), occupied_cell_aabb(occ0, 1.0),
                                nears, fars, noise, bound=1.0, max_steps=16, grid_size=H,
                                lattice_K=32)
    assert mine.valid.any() and torch.equal(mine.valid, theirs.valid)
    assert torch.equal(mine.ts, theirs.ts) and torch.equal(mine.span, theirs.span)
    mine = ref.march_walk(o, d, occ0, nears, fars, noise, bound=1.0, max_steps=16,
                          grid_size=H, dt_gamma=1 / 256)
    theirs = march_rays_train(o, d, occ0[None], nears, fars, noise, bound=1.0, dt_gamma=1 / 256,
                              max_steps=16, grid_size=H)
    assert mine.valid.any() and torch.equal(mine.valid, theirs.valid)
    assert torch.equal(mine.ts, theirs.ts)


def test_kdop_and_capacity():
    from geneface_tpu_torch.inference.radnerf_infer import pick_ray_capacity
    from geneface_tpu_torch.models.radnerf import kdop_hit, occupied_kdop

    occ = torch.as_tensor(scene.planted_occupancy(32, 10.0)[1])
    mine, theirs = ref.kdop(occ[0], 1.0), occupied_kdop(occ, 1.0)
    assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
    o, d = _rays()
    assert torch.equal(ref.kdop_hit(o, d, mine, 0.05), kdop_hit(o, d, theirs, 0.05))
    for n in (0, 1000, 70000, 300000):
        assert ref.ray_capacity(n, 512 * 512) == pick_ray_capacity(n, 512 * 512)


def test_adam_step(models):
    from geneface_tpu_torch.training.optim import MultiGroupAdam
    from geneface_tpu_torch.training.schedules import exponential_schedule

    g = torch.Generator().manual_seed(1)
    a = {"w": torch.randn(64, 8, generator=g), "t": torch.randn(100, 4, generator=g)}
    start = {k: v.clone() for k, v in a.items()}
    b = {k: v.clone() for k, v in a.items()}
    grads = [{k: torch.randn(v.shape, generator=g) for k, v in a.items()} for _ in range(3)]
    mine = ref.Adam({"net": (1.0, {"w": a["w"]}), "grid": (10.0, {"t": a["t"]})}, lr=5e-4)
    params = {k: torch.nn.Parameter(v) for k, v in b.items()}
    theirs = MultiGroupAdam([{"params": [params["w"]], "mult": 1.0},
                             {"params": [params["t"]], "mult": 10.0}],
                            exponential_schedule(5e-4), eps=1e-15)
    for gr in grads:
        mine.step(gr)
        for k, p in params.items():
            p.grad = gr[k].clone()
        theirs.step()
    # the schedule and the bias corrections in float64 here, float32 there:
    # the parameters (|p| < 5) agree to a few units in their last place
    for k in a:
        assert torch.allclose(a[k], params[k].detach(), rtol=0, atol=1e-6)
        assert not torch.equal(a[k], start[k])
