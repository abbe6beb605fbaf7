"""The port's row scatter-add (K1) against the JAX XLA scatter and the
Pallas kernel in interpret mode.

Tolerances: float32 sums of the same terms in another order — rtol 1e-5,
atol 1e-4, as the Pallas kernel's own test. Unique rows (the frame scatter)
are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneface_tpu.ops.pallas_scatter import scatter_add_rows_pallas
from geneface_tpu.ops.scatter import scatter_add_rows as jax_scatter_add_rows
from geneface_tpu_torch.ops.scatter import (
    LAUNCHES,
    scatter_add_rows,
    scatter_add_rows_plain,
)


def _port(rows, upd, R, dtype=torch.float32):
    return scatter_add_rows(
        torch.from_numpy(rows), torch.from_numpy(upd).to(dtype), R
    ).numpy()


@pytest.mark.parametrize(
    "M,R,W,chunk",
    [
        (3000, 777, 32, 1024),
        (1024, 100, 16, 512),
        (100, 8, 128, 128),
        (1024, 1024, 64, 512),
    ],
)
def test_scatter_matches_xla_and_pallas(M, R, W, chunk):
    rng = np.random.RandomState(M + R)
    rows = rng.randint(-5, R, M).astype(np.int32)  # includes OOB (dropped)
    upd = rng.randn(M, W).astype(np.float32)
    got = _port(rows, upd, R)
    ref = np.asarray(jax_scatter_add_rows(jnp.asarray(rows), jnp.asarray(upd), R))
    pal = np.asarray(
        scatter_add_rows_pallas(
            jnp.asarray(rows), jnp.asarray(upd), R, chunk=chunk, interpret=True
        )
    )
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, pal, rtol=1e-5, atol=1e-4)


def test_scatter_collision_heavy():
    """All updates land on a handful of rows."""
    M, R, W = 1500, 4, 32
    rng = np.random.RandomState(0)
    rows = rng.randint(0, R, M).astype(np.int32)
    upd = np.ones((M, W), np.float32)
    got = _port(rows, upd, R)
    pal = np.asarray(
        scatter_add_rows_pallas(
            jnp.asarray(rows), jnp.asarray(upd), R, chunk=500, interpret=True
        )
    )
    counts = np.bincount(rows, minlength=R).astype(np.float32)
    np.testing.assert_array_equal(got, counts[:, None] * np.ones((R, W)))
    np.testing.assert_allclose(got, pal, rtol=1e-6)


@pytest.mark.parametrize(
    "M,R,W,dtype",
    [
        (4096, 300, 32, torch.bfloat16),  # bf16 updates, f32 accumulation
        (50000, 4096, 6, torch.float32),  # the composite's [Mc, 6] rows
        (20000, 40000, 6, torch.float32),  # n_rows beyond the TPU's 16,384
        (3000, 20000, 16, torch.float16),
    ],
)
def test_scatter_matches_xla_oracle(M, R, W, dtype):
    rng = np.random.RandomState(M + R + W)
    rows = rng.randint(-5, R + 5, M).astype(np.int32)
    upd = rng.randn(M, W).astype(np.float32)
    upd_t = torch.from_numpy(upd).to(dtype)
    got = scatter_add_rows(torch.from_numpy(rows), upd_t, R).numpy()
    # the oracle sees the same (rounded) update values in float32
    upd_exact = upd_t.float().numpy()
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
           torch.float32: jnp.float32}[dtype]
    ref = np.asarray(
        jax_scatter_add_rows(jnp.asarray(rows), jnp.asarray(upd_exact).astype(jdt), R)
    )
    assert got.dtype == np.float32 and got.shape == (R, W)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_unique_rows_are_exact():
    """The frame scatter: unique rows plus padding rows at n_rows."""
    rng = np.random.RandomState(3)
    N, C = 5000, 1200
    idx = np.full(C, N, np.int32)
    idx[:1000] = np.sort(rng.choice(N, 1000, replace=False))
    packed = rng.rand(C, 6).astype(np.float32)
    got = _port(idx, packed, N)
    ref = np.zeros((N, 6), np.float32)
    ref[idx[:1000]] = packed[:1000]
    np.testing.assert_array_equal(got, ref)


def test_cpu_path_is_plain_and_counts_no_launch():
    before = LAUNCHES["scatter_add_rows"]
    rows = torch.tensor([0, 2, 2, -1, 7], dtype=torch.int32)
    upd = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    got = scatter_add_rows(rows, upd, 3)
    np.testing.assert_array_equal(got.numpy(), scatter_add_rows_plain(rows, upd, 3).numpy())
    np.testing.assert_array_equal(got.numpy(), [[0, 1], [0, 0], [6, 8]])
    assert LAUNCHES["scatter_add_rows"] == before


@pytest.mark.parametrize(
    "rows,upd,err",
    [
        (torch.zeros(4, dtype=torch.int64), torch.zeros(4, 2), TypeError),
        (torch.zeros(4, dtype=torch.int32), torch.zeros(4, 2, dtype=torch.float64), TypeError),
        (torch.zeros(4, dtype=torch.int32), torch.zeros(5, 2), ValueError),
        (torch.zeros(4, dtype=torch.int32), torch.zeros(2, 4).T, ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(rows, upd, err):
    with pytest.raises(err):
        scatter_add_rows(rows, upd, 3)
