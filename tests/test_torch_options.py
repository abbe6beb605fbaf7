"""The options of the RAD-NeRF path that the port once refused, against the
JAX package: the fused grid at ``grid_compute_dtype`` bf16/mixed and
``grid_bwd_dtype`` bf16, the multi-cascade walk (``bound > 1``) and its
occupancy sweep, SH degrees 5–8, and whole frames under those options.

Where the bf16 path rounds: the JAX program casts the gathered rows and the
corner weights to bfloat16, multiplies them in bfloat16 and sums the
corners in float32; its backward forms ``wexp · ggexp`` and ``rows · ggexp``
in bfloat16 and scatter-adds them in float32. Run eagerly, JAX rounds at
exactly those points and the port matches it: the forward and the table
gradients to float32 summation order (rtol 1e-5, atol 1e-6·max|ref|), the
input gradients at the float32 tests' bound (rtol 1e-4, atol
1e-6·max|ref|). Under ``jax.jit`` XLA's CPU compiler keeps the backward's
products in float32 up to the scatter and fuses the weights' float32
arithmetic differently (0.05% of the forward's values then round to the
neighbouring bfloat16): there the forward is held within 1e-3·max|ref|
(measured 1.2e-4), the gradients within 1e-2·max|ref| (measured 2.7e-3),
and the port's bfloat16 forward lies closer to JAX's bfloat16 forward than
to the port's own float32 one (measured 3e-5 against 5e-3).

The walk at 2 and 3 cascades: ``valid`` and ``ts``/``dts``/``depth_ts``
bit for bit (both round ``o + t·d`` once and take the cascade from the
same ``frexp`` exponents); the sweep over two cascades at the bounds of
``tests/test_torch_training.py``. SH: 1e-6. Frames and steps under these
options: ``tests/test_torch_options_render.py``.
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
from geneface_tpu.models.radnerf import renderer as jrend
from geneface_tpu.ops import encoders as jenc
from geneface_tpu.ops import fused_grid as jfg
from geneface_tpu.ops import raymarch as jrm
from geneface_tpu_torch.models.radnerf import (
    init_occupancy,
    mark_untrained_grid,
    model_from_cfg,
    occupancy_view,
    update_extra_state,
)
from geneface_tpu_torch.ops import (
    dense_view,
    fused_grid_encode,
    make_fused_grid_meta,
    make_grid_meta,
    march_rays_train,
    near_far_from_aabb,
    sh_encode,
)
from geneface_tpu_torch.ops.raymarch import _exponent
from geneface_tpu_torch.ops.scatter import LAUNCHES

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.make_synthetic_dataset import make_dataset  # noqa: E402

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ fused grid --
def _grid_case(D, compute, bwd, ungroup, interp, M=2000):
    kw = dict(input_dim=D, num_levels=8, level_dim=4, base_resolution=16,
              log2_hashmap_size=14 if D == 3 else 12, desired_resolution=256,
              gridtype="tiled", interpolation=interp)
    jmeta = jfg.make_fused_grid_meta(jenc.make_grid_meta(**kw), ungroup_coarse=ungroup,
                                     compute=compute, bwd_compute=bwd)
    tmeta = make_fused_grid_meta(make_grid_meta(**kw), ungroup_coarse=ungroup,
                                 compute=compute, bwd_compute=bwd)
    rng = np.random.RandomState(D + ungroup)
    shapes = jfg.init_fused_embeddings(jax.random.PRNGKey(0), jmeta)
    params = {k: rng.uniform(-1, 1, size=v.shape).astype(np.float32) for k, v in shapes.items()}
    x = rng.uniform(-0.05, 1.05, size=(M, D)).astype(np.float32)  # a few outside [0, 1]
    gout = rng.randn(M, 8 * 4).astype(np.float32)
    return jmeta, tmeta, params, x, gout


def _port_vjp(tmeta, params, x, gout):
    """The port's output, input gradient and table gradients."""
    xt = torch.from_numpy(x).requires_grad_(True)
    canon = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    tables = [dense_view(canon[f"group_{gi}"], tmeta, gi) if tmeta.modes[gi] == "dense"
              else canon[f"group_{gi}"] for gi in range(len(tmeta.groups))]
    out = fused_grid_encode(xt, tables, tmeta)
    out.backward(torch.from_numpy(gout))
    return out.detach().numpy(), xt.grad.numpy(), {k: v.grad.numpy() for k, v in canon.items()}


def _jax_vjp(jmeta, params, x, gout, jit):
    def f(xx, p):
        out, vjp = jax.vjp(lambda a, b: jfg.fused_grid_encode(a, b, jmeta), xx, p)
        return out, vjp(jnp.asarray(gout))

    out, (gx, gp) = (jax.jit(f) if jit else f)(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()})
    return np.asarray(out), np.asarray(gx), {k: np.asarray(v) for k, v in gp.items()}


def _close(got, ref, rtol):
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-6 * float(np.abs(ref).max()))


GRID_CASES = [
    (3, "bf16", "same", 0, "linear"),
    (3, "bf16", "bf16", 0, "linear"),
    (3, "mixed", "same", 3, "linear"),
    (3, "f32", "bf16", 0, "linear"),
    (2, "bf16", "bf16", 0, "linear"),
    (2, "mixed", "same", 4, "linear"),
    (2, "f32", "bf16", 3, "linear"),
    (2, "bf16", "bf16", 0, "smoothstep"),
]


@pytest.mark.parametrize("D,compute,bwd,ungroup,interp", GRID_CASES)
def test_fused_grid_options_match_eager_jax(D, compute, bwd, ungroup, interp):
    jmeta, tmeta, params, x, gout = _grid_case(D, compute, bwd, ungroup, interp)
    assert {"dense", "hash"} <= set(tmeta.modes)  # both kinds of group run
    before = dict(LAUNCHES)
    out, gx, gp = _port_vjp(tmeta, params, x, gout)
    assert LAUNCHES == before  # the CPU runs the plain versions
    jout, jgx, jgp = _jax_vjp(jmeta, params, x, gout, jit=False)
    _close(out, jout, 1e-5)
    for k in params:
        _close(gp[k], jgp[k], 1e-5)
    _close(gx, jgx, 1e-4)
    # the options do change the numbers
    _, _, gp32 = _port_vjp(make_fused_grid_meta(tmeta.base, ungroup_coarse=ungroup),
                           params, x, gout)
    assert any(np.abs(gp32[k] - gp[k]).max() > 1e-4 for k in params)


@pytest.mark.parametrize("D,compute,bwd,ungroup,interp",
                         [GRID_CASES[1], GRID_CASES[2], GRID_CASES[4]])
def test_fused_grid_options_against_jitted_jax(D, compute, bwd, ungroup, interp):
    jmeta, tmeta, params, x, gout = _grid_case(D, compute, bwd, ungroup, interp)
    out, gx, gp = _port_vjp(tmeta, params, x, gout)
    jout, jgx, jgp = _jax_vjp(jmeta, params, x, gout, jit=True)
    scale = float(np.abs(jout).max())
    assert np.abs(out - jout).max() <= 1e-3 * scale
    for k in params:
        assert np.abs(gp[k] - jgp[k]).max() <= 1e-2 * float(np.abs(jgp[k]).max()), k
    assert np.abs(gx - jgx).max() <= 1e-2 * float(np.abs(jgx).max())
    out32, _, _ = _port_vjp(make_fused_grid_meta(tmeta.base, ungroup_coarse=ungroup),
                            params, x, gout)
    assert np.abs(out - jout).max() < 0.1 * np.abs(out32 - jout).max()


def test_fused_grid_meta_refuses_unknown_dtypes():
    meta = make_grid_meta(input_dim=2, num_levels=4, level_dim=2)
    with pytest.raises(ValueError, match="compute"):
        make_fused_grid_meta(meta, compute="f16")
    with pytest.raises(ValueError, match="bwd_compute"):
        make_fused_grid_meta(meta, bwd_compute="f32")


def test_reference_and_block_backends_ignore_the_grid_dtypes():
    """The JAX package passes the dtypes to the fused metas only."""
    cfg = dict(cond_out_dim=16, smo_win_size=3, log2_hashmap_size=12, desired_resolution=128,
               hidden_dim_ambient=16, hidden_dim_sigma=16, geo_feat_dim=16,
               hidden_dim_color=16, num_layers_ambient=2, num_layers_sigma=2,
               individual_embedding_num=4)
    rng = np.random.RandomState(0)
    xyz = _t(rng.uniform(-1, 1, (300, 3)).astype(np.float32))
    d = _t(rng.randn(300, 3).astype(np.float32))
    feat = torch.zeros(1, 16)
    for backend in ("reference", "block"):
        outs = []
        for opts in ({}, {"grid_compute_dtype": "bf16", "grid_bwd_dtype": "bf16"}):
            model = model_from_cfg({**cfg, "grid_backend": backend, **opts},
                                   dtype=torch.float32)
            model.reset_parameters(torch.Generator().manual_seed(0))
            with torch.no_grad():
                outs.append(model(xyz, d, feat, None))
        for a, b in zip(*outs):
            assert torch.equal(a, b), backend


# ------------------------------------------------------------------ walk --
def test_exponent_matches_frexp_at_level_boundaries():
    """The walk's cascade comes from ``frexp`` exponents: the ties at
    powers of two and their neighbours, as ``jnp.frexp`` gives them."""
    vals = []
    for e in range(-3, 5):
        p = np.float32(2.0**e)
        vals += [np.nextafter(p, np.float32(0)), p, np.nextafter(p, np.float32(np.inf))]
    x = np.asarray(vals + [0.0, 1e-31, 0.75, 1.5], np.float32)
    want = np.asarray(jrm._exponent(jnp.asarray(x)))
    np.testing.assert_array_equal(_exponent(_t(x)).numpy(), want)


def _cascade_scene(bound, S, seed):
    """A seeded grid per cascade (a ball plus scattered cells) and rays from
    a camera in front of the box."""
    C = 1 + int(np.ceil(np.log2(bound)))
    H = 32
    rng = np.random.RandomState(seed)
    occ = rng.rand(C, H, H, H) < 0.05
    r = (np.arange(H) + 0.5) / H * 2 - 1
    gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
    occ |= (np.sqrt(gx**2 + gy**2 + gz**2) < 0.5)[None]
    N = 3000
    ro = np.array([[0.0, 0.0, 2.5 * bound]], np.float32) + rng.randn(N, 3).astype(np.float32) * 0.1
    rd = rng.uniform(-0.8 * bound, 0.8 * bound, (N, 3)).astype(np.float32) - ro
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return C, H, occ, ro, rd, rng.rand(N).astype(np.float32)


@pytest.mark.parametrize("bound,S,dt_gamma", [(2.0, 16, 1 / 256), (2.0, 48, 1 / 16),
                                              (4.0, 16, 1 / 256), (3.0, 16, 1 / 128)])
def test_multi_cascade_walk_matches_jax(bound, S, dt_gamma):
    C, H, occ, ro, rd, noises = _cascade_scene(bound, S, seed=int(bound * 10) + S)
    aabb = jrend.make_aabb(bound)
    jn, jf = jrm.near_far_from_aabb(jnp.asarray(ro), jnp.asarray(rd), aabb, 0.05)
    want = jrm.march_rays_train(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(occ), jn, jf, jnp.asarray(noises),
        bound=bound, dt_gamma=dt_gamma, max_steps=S, cascade=C, grid_size=H,
    )
    tn, tf = near_far_from_aabb(_t(ro), _t(rd), _t(aabb), 0.05)
    got = march_rays_train(_t(ro), _t(rd), _t(occ), tn, tf, _t(noises), bound=bound,
                           dt_gamma=dt_gamma, max_steps=S, grid_size=H)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    for k in ("ts", "dts", "depth_ts"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    # samples in the outer cascades, and steps longer than one level-0 cell
    ts = got.ts.numpy()[valid]
    ray = np.nonzero(valid)[0]
    pos = ro[ray] + ts[:, None] * rd[ray]
    assert valid.sum(-1).mean() > 1.5 and (np.abs(pos).max(-1) > 1.0).sum() > 100
    assert got.dts.numpy()[valid].max() > 2 * np.sqrt(3) / H


def test_occupancy_sweep_over_two_cascades_matches_jax(tmp_path):
    """``mark_untrained_grid`` and two ``update_extra_state`` sweeps at
    ``bound: 2`` (two cascades), with JAX's noise."""
    make_dataset(str(tmp_path), n_frames=6, hw=32)
    cfg = dict(cond_type="idexp_lm3d_normalized", smo_win_size=3, grid_size=16)
    jds = JDataset("train", str(tmp_path), JConfig(cfg), training=False)
    H, bound = 16, 2.0
    jocc = jrend.mark_untrained_grid(jrend.init_occupancy(H, bound), jds.poses,
                                     jds.intrinsics, H, bound)
    tocc = mark_untrained_grid(init_occupancy(H, bound), jds.poses, jds.intrinsics, H, bound)
    assert tocc.density_grid.shape == (2, H**3)
    np.testing.assert_array_equal(tocc.density_grid.numpy(), np.asarray(jocc.density_grid))

    def dens_np(x):
        return 30.0 * np.exp(-1.5 * (x**2).sum(-1))

    rng = jax.random.PRNGKey(7)
    for _ in range(2):
        jocc = jrend.update_extra_state(
            lambda x: 30.0 * jnp.exp(-1.5 * jnp.sum(x**2, -1)), jocc, rng,
            grid_size=H, bound=bound, density_thresh=10.0,
        )
        noise = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(rng, c), (H**3, 3)))
                          for c in range(2)])
        tocc = update_extra_state(
            lambda x: torch.from_numpy(dens_np(x.numpy())).float(), tocc, _t(noise),
            grid_size=H, bound=bound, density_thresh=10.0,
        )
        rng = jax.random.fold_in(rng, 1)
    dens = np.asarray(jocc.density_grid)
    np.testing.assert_allclose(tocc.density_grid.numpy(), dens, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tocc.mean_density), float(jocc.mean_density), rtol=1e-5)
    away = (np.abs(dens - min(float(jocc.mean_density), 10.0)) > 1e-5).reshape(2, H, H, H)
    np.testing.assert_array_equal(tocc.occ_grid.numpy()[away], np.asarray(jocc.occ_grid)[away])
    assert tocc.occ_grid[1].any() and not tocc.occ_grid[1].all()
    view = occupancy_view(tocc.occ_grid, bound)  # the walk's: no lattice blocks
    assert view.blocks is None and view.tight is None and view.grid is tocc.occ_grid


# -------------------------------------------------------------------- SH --
def test_sh_encode_degrees_1_to_8():
    rng = np.random.RandomState(0)
    d = rng.randn(500, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for degree in range(1, 9):
        ref = np.asarray(jenc.sh_encode(jnp.asarray(d), degree))
        got = sh_encode(_t(d), degree).numpy()
        assert got.shape == (500, degree**2)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6, err_msg=str(degree))
    with pytest.raises(ValueError):
        sh_encode(_t(d), 9)
