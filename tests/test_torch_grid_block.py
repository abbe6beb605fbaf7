"""The ``block`` grid backend (``ops/encoders.py::fast_grid_encode``) against
the JAX package's on the CPU: its forward (bfloat16 fast tables, one row
gather per level) and both gradients (one scatter per level into the local
table, the adjoint of the table build, the closed-form input gradient),
tiled and hash grids, linear and smoothstep, 2-D and 3-D, dense and
block-hashed (capped) levels, points outside [0, 1].

Tolerances: the forward and the fast tables 1e-6 absolute (the tables are
equal; the same bfloat16 values are summed); gradients within
``2·n·2⁻²⁴·Σ|u|`` of ``jax.vjp`` per entry, as K1's sums are held (``n`` the
terms of an entry, counted with the port's own row addressing; an input
gradient's ``n`` grows by ``D + 1`` for the rounded factors of each term,
and its ``Σ|u|`` is bounded with every weight at 1). On uncapped levels the
block layout's interpolation is the reference's: equal to ``grid_encode``
at float32 tables.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneface_tpu.ops import encoders as J
from geneface_tpu_torch.ops import encoders as T
from geneface_tpu_torch.ops.scatter import LAUNCHES, scatter_add_rows_plain

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)

EPS = 2.0**-24


def metas(D, gridtype, interp, log2_hashmap_size, levels=6, desired=128):
    kw = dict(input_dim=D, num_levels=levels, level_dim=2, base_resolution=16,
              log2_hashmap_size=log2_hashmap_size, desired_resolution=desired,
              gridtype=gridtype, interpolation=interp)
    jm, tm = J.make_grid_meta(**kw), T.make_grid_meta(**kw)
    return J.make_block_grid_meta(jm), T.make_block_grid_meta(tm)


def table_bounds(x, g, bm):
    """Per canonical entry: terms ``n`` and ``Σ|u|`` of its gradient."""
    meta = bm.base
    D, C = meta.input_dim, meta.level_dim
    K = 1 << D
    xt = torch.from_numpy(x)
    oob = ((xt < 0) | (xt > 1)).any(-1)
    comps = [xt[:, d].clamp(0, 1) for d in range(D)]
    gt = torch.where(oob[:, None], 0.0, torch.from_numpy(g))
    counts, sums = [], []
    for lvl in range(meta.num_levels):
        frac, row = T._block_level_rows(comps, bm, lvl)
        w = T._corner_weights(frac, K)
        gl = gt[:, lvl * C:(lvl + 1) * C]
        ones = (~oob).float()[:, None].expand(-1, K * C).contiguous()
        upd = (w[:, :, None] * gl[:, None, :]).abs().reshape(-1, K * C)
        counts.append(scatter_add_rows_plain(row, ones, bm.level_rows(lvl)))
        sums.append(scatter_add_rows_plain(row, upd, bm.level_rows(lvl)))
    return (T._block_tables_adjoint(counts, bm).double().numpy(),
            T._block_tables_adjoint(sums, bm).double().numpy())


def input_bound(x, g, emb, bm):
    """Per input: an upper bound of ``Σ|u|`` of its gradient (every weight
    at 1, every table value at the largest)."""
    meta = bm.base
    C = meta.level_dim
    K = 1 << meta.input_dim
    chain = 1.5 if meta.interpolation == "smoothstep" else 1.0
    vmax = float(np.abs(emb).max())
    out = np.zeros(len(x))
    for lvl in range(meta.num_levels):
        gl = np.abs(g[:, lvl * C:(lvl + 1) * C]).sum(-1)
        out += T.level_scale(meta, lvl) * chain * K * vmax * gl
    return out[:, None]


CASES = [
    (3, "tiled", "linear", 13),
    (3, "hash", "smoothstep", 13),
    (2, "tiled", "smoothstep", 12),
    (2, "hash", "linear", 12),
]


@pytest.mark.parametrize("D,gridtype,interp,log2h", CASES,
                         ids=[f"{d}d-{g}-{i}-2^{h}" for d, g, i, h in CASES])
def test_fast_grid_encode_matches_jax(D, gridtype, interp, log2h):
    jb, tb = metas(D, gridtype, interp, log2h)
    assert jb.modes == tb.modes and jb.row_offsets == tb.row_offsets
    assert "dense" in tb.modes and "block_hash" in tb.modes
    rng = np.random.RandomState(D * 11 + log2h)
    emb = rng.uniform(-1, 1, (tb.base.n_entries, 2)).astype(np.float32)
    x = rng.uniform(-0.05, 1.05, (500, D)).astype(np.float32)
    g = rng.randn(500, tb.output_dim).astype(np.float32)

    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(J.build_block_tables(jnp.asarray(emb), jb, dtype=jdt).astype(jnp.float32))
        got = T.build_block_tables(torch.from_numpy(emb), tb, dtype=tdt)
        assert got.dtype == tdt and got.shape == (tb.total_rows, tb.row_width)
        np.testing.assert_array_equal(got.float().numpy(), want)

    want, vjp = jax.vjp(lambda a, b: J.fast_grid_encode(a, b, jb), jnp.asarray(x),
                        jnp.asarray(emb))
    jgx, jge = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    xt = torch.tensor(x, requires_grad=True)
    et = torch.tensor(emb, requires_grad=True)
    before = dict(LAUNCHES)
    got = T.fast_grid_encode(xt, et, tb)
    (got * torch.from_numpy(g)).sum().backward()
    assert LAUNCHES == before  # the CPU runs the plain versions
    oob = ((x < 0) | (x > 1)).any(-1)
    assert oob.sum() > 20 and np.all(got.detach().numpy()[oob] == 0)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)

    n, a = table_bounds(x, g, tb)
    assert n.max() >= 2  # entries do sum several terms
    np.testing.assert_array_less(np.abs(et.grad.numpy() - jge), 2 * n * EPS * a + 1e-30)
    gxt = xt.grad.numpy()
    assert np.all(gxt[oob] == 0) and np.abs(gxt).max() > 0
    n_in = tb.num_levels * (1 << D) * tb.level_dim + D + 1
    bound = np.broadcast_to(2 * n_in * EPS * input_bound(x, g, emb, tb), gxt.shape)
    np.testing.assert_array_less(np.abs(gxt - jgx), bound)


@pytest.mark.parametrize("D", [2, 3])
def test_block_equals_reference_on_dense_levels(D):
    """The fast table at float32 read by the block layout gives the
    reference's interpolation on every uncapped level (all of them here)."""
    _, tb = metas(D, "tiled", "linear", 16, levels=4, desired=32)
    assert all(m == "dense" for m in tb.modes)
    rng = np.random.RandomState(D)
    emb = torch.from_numpy(rng.uniform(-1, 1, (tb.base.n_entries, 2)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(0, 1, (400, D)).astype(np.float32))
    ref = T.grid_encode(x, emb, tb.base)
    blk = T.block_grid_encode(x, T.build_block_tables(emb, tb, torch.float32), tb)
    np.testing.assert_allclose(blk.numpy(), ref.numpy(), rtol=0, atol=1e-6)
    # and the bfloat16 fast path within the tables' rounding
    fast = T.fast_grid_encode(x, emb, tb)
    np.testing.assert_allclose(fast.numpy(), ref.numpy(), rtol=0, atol=2 * 2.0**-8)


def test_table_adjoint_is_the_build_transpose():
    """``_block_tables_adjoint`` against autograd of the float32 build."""
    _, tb = metas(3, "hash", "linear", 13, levels=5, desired=96)
    assert "dense" in tb.modes and "block_hash" in tb.modes
    rng = np.random.RandomState(1)
    emb = torch.zeros(tb.base.n_entries, 2, requires_grad=True)
    gt = torch.from_numpy(rng.randn(tb.total_rows, tb.row_width).astype(np.float32))
    (T.build_block_tables(emb, tb, torch.float32) * gt).sum().backward()
    parts = [gt[tb.row_offsets[l]:tb.row_offsets[l + 1]] for l in range(tb.num_levels)]
    got = T._block_tables_adjoint(parts, tb)
    # each canonical entry sums at most K·K = 64 copies
    np.testing.assert_allclose(got.numpy(), emb.grad.numpy(), rtol=0,
                               atol=64 * EPS * float(gt.abs().max()) * 2)


def test_capped_rows_hash_like_jax():
    """The block-hash rows of capped levels (the uint32 prime-xor of block
    coordinates and parity) are JAX's, bit for bit."""
    jb, tb = metas(3, "hash", "linear", 10, levels=8, desired=2048)
    rng = np.random.RandomState(2)
    x = rng.uniform(0, 1, (3000, 3)).astype(np.float32)
    comps_t = [torch.from_numpy(x[:, d]) for d in range(3)]
    comps_j = [jnp.asarray(x[:, d]) for d in range(3)]
    for lvl in range(8):
        got = T._block_level_rows(comps_t, tb, lvl)[1].numpy()
        want = np.asarray(J._block_level_rows(comps_j, jb, lvl)[4]) - jb.row_offsets[lvl]
        np.testing.assert_array_equal(got, want)
    assert tb.modes[-1] == "block_hash" and math.prod(tb.level_sides[-1:]) > 1000
