"""Port ops against their JAX counterparts on shared numpy inputs.

Tolerances: integer outputs (march slots, compaction plans, packed
occupancy, grid rows) must match exactly; float32 results that sum the
same terms in another order get rtol/atol 1e-6..1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneface_tpu.ops import activations as jact
from geneface_tpu.ops import compaction as jcomp
from geneface_tpu.ops import encoders as jenc
from geneface_tpu.ops import fused_grid as jfg
from geneface_tpu.ops import raymarch as jrm
from geneface_tpu_torch.ops import (
    compact_gather,
    dense_view,
    fused_grid_encode,
    make_compact_plan,
    make_fused_grid_meta,
    make_grid_meta,
    march_rays_lattice,
    near_far_from_aabb,
    occupied_cell_aabb,
    pack_occ_blocks,
    segmented_cumsum,
    sh_encode,
    trunc_exp,
    waterfill_valid,
)

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_sh_encode_matches():
    rng = np.random.RandomState(0)
    d = rng.randn(500, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for degree in (1, 2, 3, 4):
        ref = np.asarray(jenc.sh_encode(jnp.asarray(d), degree))
        got = sh_encode(_t(d), degree).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_trunc_exp_value_and_clamped_grad():
    x = np.asarray([-30.0, -2.0, 0.0, 3.0, 20.0], np.float32)
    ref_y = np.asarray(jact.trunc_exp(jnp.asarray(x)))
    ref_g = np.asarray(jax.grad(lambda v: jnp.sum(jact.trunc_exp(v)))(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    y = trunc_exp(xt)
    y.sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), ref_y, rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), ref_g, rtol=1e-6)


def _grid_case(D, ungroup, seed):
    kw = dict(
        input_dim=D, num_levels=8, level_dim=4, base_resolution=16,
        log2_hashmap_size=16, desired_resolution=512, gridtype="tiled",
    )
    jmeta = jfg.make_fused_grid_meta(jenc.make_grid_meta(**kw), ungroup_coarse=ungroup)
    tmeta = make_fused_grid_meta(make_grid_meta(**kw), ungroup_coarse=ungroup)
    rng = np.random.RandomState(seed)
    params = {
        f"group_{gi}": rng.uniform(-1, 1, size=jfg.init_fused_embeddings(
            jax.random.PRNGKey(0), jmeta)[f"group_{gi}"].shape).astype(np.float32)
        for gi in range(len(jmeta.groups))
    }
    x = rng.uniform(-0.1, 1.1, size=(3000, D)).astype(np.float32)  # some OOB
    return jmeta, tmeta, params, x


@pytest.mark.parametrize("D,ungroup", [(3, 0), (3, 4), (2, 0), (2, 4)])
def test_fused_grid_encode_matches(D, ungroup):
    jmeta, tmeta, params, x = _grid_case(D, ungroup, seed=D * 10 + ungroup)
    assert tmeta.groups == jmeta.groups and tmeta.modes == jmeta.modes
    assert tmeta.n_rows == jmeta.n_rows
    if ungroup:
        assert tmeta.modes[1] == "dense"
    ref = np.asarray(jfg.fused_grid_encode(jnp.asarray(x), params, jmeta, False))
    tables = [
        dense_view(_t(params[f"group_{gi}"]), tmeta, gi)
        if tmeta.modes[gi] == "dense" else _t(params[f"group_{gi}"])
        for gi in range(len(tmeta.groups))
    ]
    got = fused_grid_encode(_t(x), tables, tmeta).numpy()
    oob = ((x < 0) | (x > 1)).any(-1)
    assert oob.any() and np.all(got[oob] == 0)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    # coordinate-column form (the ambient grid's input) gives the same
    cols = tuple(_t(x[:, d]) for d in range(D))
    np.testing.assert_array_equal(fused_grid_encode(cols, tables, tmeta).numpy(), got)


def _ball(H, radius):
    r = (np.arange(H) + 0.5) / H * 2.0 - 1.0
    gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
    return np.sqrt(gx**2 + gy**2 + gz**2) < radius


def test_pack_occ_blocks_matches():
    rng = np.random.RandomState(1)
    occ = rng.rand(32, 32, 32) < 0.3
    ref = np.asarray(jrm.pack_occ_blocks(jnp.asarray(occ), block=8))
    got = pack_occ_blocks(_t(occ)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, ref)


def _rays(N, seed):
    rng = np.random.RandomState(seed)
    o = np.tile(np.asarray([[0.1, 0.05, 2.2]], np.float32), (N, 1))
    tgt = rng.uniform(-0.8, 0.8, size=(N, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


@pytest.mark.parametrize("noise", [False, True])
def test_march_rays_lattice_exact(noise):
    H, S, K, N = 32, 8, 48, 3000
    occ = _ball(H, 0.5)
    occ[3:6, 20:24, 10:14] = True  # an off-centre blob: holes along rays
    o, d = _rays(N, 2)
    noises = (np.random.RandomState(3).rand(N) if noise else np.zeros(N)).astype(np.float32)
    aabb = np.asarray([-1, -0.5, -1, 1, 0.5, 1], np.float32)
    jn, jf = jrm.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb), 0.05)
    ref = jrm.march_rays_lattice(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(occ[None]), jn, jf,
        jnp.asarray(noises), bound=1.0, max_steps=S, grid_size=H, lattice_K=K,
        paired=False,
    )
    tn, tf = near_far_from_aabb(_t(o), _t(d), _t(aabb), 0.05)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    occ_t = _t(occ)
    got = march_rays_lattice(
        _t(o), _t(d), pack_occ_blocks(occ_t), occupied_cell_aabb(occ_t, 1.0),
        tn, tf, _t(noises), bound=1.0, max_steps=S, grid_size=H, lattice_K=K,
    )
    assert np.asarray(ref.valid).sum() > N  # the march found real samples
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.ks.numpy(), np.asarray(ref.ks))
    # positions: the port rounds each multiply-add once, as the reference's
    # fused code does; with jitter the reference's compiler fuses t0 into one
    # of its uses only, which leaves a few positions 1 ulp apart
    for field in ("t_start", "ts", "depth_ts"):
        np.testing.assert_allclose(
            getattr(got, field).numpy(), np.asarray(getattr(ref, field)),
            rtol=1.2e-7 if noise else 0, atol=0, err_msg=field,
        )
    assert int(got.span) == int(ref.span)


def _prefix_valid(N, S, seed):
    n = np.random.RandomState(seed).randint(0, S + 1, N)
    n[::7] = 0
    return np.arange(S)[None, :] < n[:, None]


@pytest.mark.parametrize("capacity", [4096, 1024, 300])  # fits / overflows
def test_waterfill_and_compact_plan_match(capacity):
    N, S = 700, 8
    valid = _prefix_valid(N, S, 4)
    jv = jcomp.waterfill_valid(jnp.asarray(valid), capacity)
    tv = waterfill_valid(_t(valid), capacity)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if capacity >= valid.sum():
        np.testing.assert_array_equal(tv.numpy(), valid)
    else:
        assert int(tv.sum()) <= capacity
    jp = jcomp.make_compact_plan(jv, capacity)
    tp = make_compact_plan(tv, capacity)
    for field in ("ray", "src", "valid", "offset", "n", "is_start"):
        np.testing.assert_array_equal(
            getattr(tp, field).numpy(), np.asarray(getattr(jp, field)), err_msg=field
        )
    assert int(tp.total) == int(jp.total)
    slab = np.random.RandomState(5).randn(N, S, 3).astype(np.float32)
    np.testing.assert_array_equal(
        compact_gather(tp, _t(slab)).numpy(),
        np.asarray(jcomp.compact_gather(jp, jnp.asarray(slab))),
    )


def test_segmented_cumsum_matches():
    N, S = 900, 16
    valid = _prefix_valid(N, S, 6)
    cap = int(valid.sum())
    plan = jcomp.make_compact_plan(jnp.asarray(valid), cap)
    vals = np.random.RandomState(7).rand(cap).astype(np.float32) * 3
    ref = np.asarray(jcomp.segmented_cumsum(jnp.asarray(vals), plan.is_start))
    got = segmented_cumsum(_t(vals), _t(np.asarray(plan.is_start))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # segment-local: every segment's prefix equals its own numpy cumsum
    starts = np.flatnonzero(np.asarray(plan.is_start))
    for a, b in zip(starts, list(starts[1:]) + [cap]):
        np.testing.assert_allclose(got[a:b], np.cumsum(vals[a:b]), rtol=1e-6)
