"""The ``reference`` grid backend (``ops/encoders.py::grid_encode``) against
the JAX package's ``grid_encode`` on the CPU: tiled and hash grids, linear
and smoothstep interpolation, 2-D and 3-D, levels that are dense and levels
capped by the hashmap (their uint32 hash wraps), and points outside [0, 1].

Tolerances:
- forward: 1e-6 absolute (the same corners and weights; the value is the
  same float32 sum, so it comes out equal here);
- gradients against ``jax.vjp``: each entry is a float32 sum of ``n`` terms
  ``u`` in another order on each side, so the two lie within
  ``2·n·2⁻²⁴·Σ|u|`` of each other (as K1's sums are held), with ``n`` and
  ``Σ|u|`` counted per entry by a float64 numpy version of the encoder; an
  input gradient's terms are products of ``D + 1`` rounded factors, so it
  is held with ``n + D + 1`` in place of ``n``; each side is also held to
  the float64 version within half of that plus the roundings of the
  interpolation weights (``2D``, or ``5D`` with smoothstep, each at most
  2⁻²⁴ absolute: ``1 − smoothstep(f)`` cancels) times ``Σ|g|``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneface_tpu.ops import encoders as J
from geneface_tpu_torch.ops import encoders as T
from geneface_tpu_torch.ops.scatter import LAUNCHES

EPS = 2.0**-24
HASH_PRIMES = (1, 2654435761, 805459861, 3674653429)


def metas(D, gridtype, interp, log2_hashmap_size, levels=6, desired=128):
    kw = dict(input_dim=D, num_levels=levels, level_dim=2, base_resolution=16,
              log2_hashmap_size=log2_hashmap_size, desired_resolution=desired,
              gridtype=gridtype, interpolation=interp)
    return J.make_grid_meta(**kw), T.make_grid_meta(**kw)


def numpy_grid(x, emb, g, meta):
    """Float64 numpy version on the float32 cells: (table gradient, its
    term counts, Σ|terms| and Σ|g| per entry; input gradient, Σ|terms| per
    input)."""
    M, D = x.shape
    C = meta.level_dim
    K = 1 << D
    oob = ((x < 0) | (x > 1)).any(-1)
    xc = np.clip(x, 0, 1).astype(np.float32)
    g = np.where(oob[:, None], 0.0, g.astype(np.float64))
    G = np.zeros(emb.shape)
    N = np.zeros(emb.shape[0])
    A = np.zeros(emb.shape)
    A1 = np.zeros(emb.shape)
    gx = np.zeros((M, D))
    ax = np.zeros((M, D))
    for lvl in range(meta.num_levels):
        scale = math.exp2(lvl * math.log2(meta.per_level_scale)) * meta.base_resolution - 1.0
        hashmap = meta.offsets[lvl + 1] - meta.offsets[lvl]
        side = int(math.ceil(scale)) + 2
        pos = xc * np.float32(scale) + np.float32(0.5)  # float32, as both sides
        base = np.floor(pos).astype(np.int64)
        f = (pos - np.floor(pos)).astype(np.float64)
        if meta.interpolation == "smoothstep":
            fs, dfs = f * f * (3 - 2 * f), 6 * f * (1 - f)
        else:
            fs, dfs = f, np.ones_like(f)
        gl = g[:, lvl * C:(lvl + 1) * C]
        for k in range(K):
            bits = [(k >> d) & 1 for d in range(D)]
            c = base + np.asarray(bits)
            stride, idx = 1, np.zeros(M, np.int64)
            for d in range(D):
                if stride > hashmap:
                    break
                idx = (idx + c[:, d] * stride) & 0xFFFFFFFF
                stride *= side
            if meta.gridtype == "hash" and stride > hashmap:
                idx = (c[:, 0] * HASH_PRIMES[0]) & 0xFFFFFFFF
                for d in range(1, D):
                    idx ^= (c[:, d] * HASH_PRIMES[d]) & 0xFFFFFFFF
            row = meta.offsets[lvl] + idx % hashmap
            wd = [np.where(bits[d], fs[:, d], 1 - fs[:, d]) for d in range(D)]
            w = np.prod(wd, axis=0)
            np.add.at(G, row, w[:, None] * gl)
            np.add.at(A, row, np.abs(w[:, None] * gl))
            np.add.at(A1, row, np.abs(gl))
            np.add.at(N, row, (~oob).astype(np.float64))
            vg = (emb[row].astype(np.float64) * gl).sum(-1)
            avg = (np.abs(emb[row]) * np.abs(gl)).sum(-1)
            for d in range(D):
                others = np.prod([wd[e] for e in range(D) if e != d], axis=0) if D > 1 else 1.0
                t = (1 if bits[d] else -1) * others * dfs[:, d] * scale
                gx[:, d] += t * vg
                ax[:, d] += np.abs(t) * avg
    gx[oob] = 0
    return G, N, A, A1, gx, ax


CASES = [
    # (D, gridtype, interpolation, log2_hashmap_size): 3-D levels from res 16
    # (17³ = 4,913 entries) to 128; 2-D levels to 128² (a hash of 2^12 caps
    # the finer half of each)
    (3, "tiled", "linear", 13),
    (3, "hash", "smoothstep", 13),
    (3, "hash", "linear", 10),
    (2, "tiled", "smoothstep", 12),
    (2, "hash", "linear", 12),
]


@pytest.mark.parametrize("D,gridtype,interp,log2h", CASES,
                         ids=[f"{d}d-{g}-{i}-2^{h}" for d, g, i, h in CASES])
def test_grid_encode_matches_jax(D, gridtype, interp, log2h):
    jm, tm = metas(D, gridtype, interp, log2h)
    assert tuple(jm.offsets) == tuple(tm.offsets)
    sides = [int(math.ceil(T.level_scale(tm, l))) + 2 for l in range(tm.num_levels)]
    sizes = [tm.offsets[l + 1] - tm.offsets[l] for l in range(tm.num_levels)]
    capped = [s**D > n for s, n in zip(sides, sizes)]
    assert any(capped) and (log2h == 10 or not all(capped)), capped
    rng = np.random.RandomState(D * 7 + log2h)
    emb = rng.uniform(-1, 1, (tm.n_entries, 2)).astype(np.float32)
    x = rng.uniform(-0.05, 1.05, (600, D)).astype(np.float32)
    x[:4] = [[0.0] * D, [1.0] * D, [0.5] * D, [1.0 + 1e-3] + [0.5] * (D - 1)]
    g = rng.randn(600, tm.output_dim).astype(np.float32)

    want, vjp = jax.vjp(lambda a, b: J.grid_encode(a, b, jm), jnp.asarray(x), jnp.asarray(emb))
    jgx, jge = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    xt = torch.tensor(x, requires_grad=True)
    et = torch.tensor(emb, requires_grad=True)
    before = dict(LAUNCHES)
    got = T.grid_encode(xt, et, tm)
    (got * torch.from_numpy(g)).sum().backward()
    assert LAUNCHES == before  # the CPU runs the plain versions

    oob = ((x < 0) | (x > 1)).any(-1)
    assert oob.sum() > 20 and np.all(got.detach().numpy()[oob] == 0)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)

    G, N, A, A1, gx, ax = numpy_grid(x, emb, g, tm)
    ge = et.grad.numpy()
    # against float64: n sums, plus the roundings of each term's weight
    # (per axis 1 for linear, 4 for smoothstep, then the product and g),
    # each an error of 2^-24 of 1 at most (1 − smoothstep(f) cancels)
    r = (5 if interp == "smoothstep" else 2) * D
    np.testing.assert_array_less(np.abs(ge - G), N[:, None] * EPS * A + r * EPS * A1 + 1e-30)
    np.testing.assert_array_less(np.abs(ge - jge), 2 * N[:, None] * EPS * A + 1e-30)
    gxt = xt.grad.numpy()
    assert np.all(gxt[oob] == 0) and np.abs(gxt).max() > 0
    # on the boundary itself (an input exactly 0 or 1) JAX's clip splits
    # the gradient between its two branches (half of it); torch's clamp
    # passes it whole: those inputs are held to the float64 version only
    edge = ((x == 0) | (x == 1)).any(-1)
    assert edge.sum() == 2
    n_in = tm.num_levels * (1 << D) * tm.level_dim + D + 1
    np.testing.assert_array_less(np.abs(gxt - jgx)[~edge], 2 * n_in * EPS * ax[~edge] + 1e-30)
    np.testing.assert_array_less(np.abs(gxt - gx), n_in * EPS * ax + 1e-30)


def test_capped_hash_levels_wrap_uint32_bit_for_bit():
    """The finest 3-D levels of a 2^10 hash: the prime products overflow
    32 bits; every corner's entry equals the JAX ``_corner_index_1d``."""
    jm, tm = metas(3, "hash", "linear", 10, levels=8, desired=2048)
    rng = np.random.RandomState(0)
    comps = [rng.randint(0, 2049, 5000).astype(np.int64) for _ in range(3)]
    for lvl in (5, 7):
        scale = T.level_scale(tm, lvl)
        res = int(math.ceil(scale)) + 1
        hashmap = tm.offsets[lvl + 1] - tm.offsets[lvl]
        assert (res + 1) ** 3 > hashmap
        got = T._corner_index_1d([torch.from_numpy(c) for c in comps], tm, res, hashmap).numpy()
        want = np.asarray(J._corner_index_1d([jnp.asarray(c, jnp.uint32) for c in comps],
                                             jm, res, hashmap))
        assert (comps[1] * HASH_PRIMES[1] >= 2**32).any()
        np.testing.assert_array_equal(got, want.astype(np.int64))


def test_init_is_uniform_in_the_reference_range():
    _, tm = metas(3, "tiled", "linear", 13)
    e = T.init_grid_embeddings(torch.Generator().manual_seed(0), tm)
    assert e.shape == (tm.n_entries, 2) and e.dtype == torch.float32
    assert float(e.abs().max()) <= 1e-4 and float(e.std()) > 5e-5
