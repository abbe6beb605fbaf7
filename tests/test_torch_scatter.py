"""The port's row scatter-add (K1) against the JAX XLA scatter and the
Pallas kernel in interpret mode.

Tolerances: float32 sums of the same terms in another order — rtol 1e-5,
atol 1e-4, as the Pallas kernel's own test. Unique rows (the frame scatter)
are exact.

The choice of the CUDA kernel's variant is pure Python and is held here on
the CPU: the shapes of the head's render and training step, the
shared-memory limit, and what each variant refuses (checked before the
wrapper looks at the device, so the CPU refuses what the card would).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneface_tpu.ops.pallas_scatter import scatter_add_rows_pallas
from geneface_tpu.ops.scatter import scatter_add_rows as jax_scatter_add_rows
from geneface_tpu_torch.ops.scatter import (
    LAUNCHES,
    SMEM_LIMIT,
    VARIANTS,
    launch_scatter_add_rows,
    pick_scatter_variant,
    scatter_add_rows,
    scatter_add_rows_plain,
    scatter_variant_accepts,
    smem_plan,
)

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)


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


@pytest.mark.parametrize(
    "M,W,n_rows,want",
    [
        (655360, 16, 324, "smem"),  # ambient grid, coarse group: 20.7 KB table
        (655360, 224, 4096, "sorted"),  # position grid, hashed group: 587 MB of updates
        (655360, 112, 5466, "sorted"),  # ambient grid, fine group
        (10000, 224, 4096, "vec"),  # the same table with few updates: no sort
        (655360, 32, 5832, "vec"),  # position grid, dense group: runs of ~3 equal rows
        (1081344, 6, 135168, "runs"),  # serving composite, ray-major rows
        (655360, 6, 65536, "runs"),  # training composite
        (135168, 6, 262144, "runs"),  # frame scatter, unique rows
        (65536, 16, 324, "smem"),  # that shape where the rows pile up (see the spread test)
        (65536, 112, 5466, "vec"),  # torso grid backward, fine group: no sort
        (32768, 16, 324, "smem"),  # lip step (4,096 rays), ambient coarse group
        (32768, 112, 5466, "vec"),  # lip step, ambient fine group
        (32768, 32, 5832, "vec"),  # lip step, position dense group
        (32768, 224, 4096, "vec"),  # lip step, position hashed group
        (32768, 6, 4096, "runs"),  # lip step composite
        (320, 60, 13120, "atomic"),  # stage A's mouth clip adjoint: too few updates for vec
        (320, 60, 30464, "atomic"),  # the same on the store's larger batch
    ],
)
def test_variant_of_the_main_path_shapes(M, W, n_rows, want):
    assert pick_scatter_variant(M, W, n_rows, 4, True) == want
    assert scatter_variant_accepts(want, M, W, n_rows, 4, True)
    # 16-bit updates take the same kernels (widened in registers)
    assert pick_scatter_variant(M, W, n_rows, 2, True) == want


@pytest.mark.parametrize(
    "M,W,n_rows,want",
    [
        (65536, 16, 324, "vec"),  # torso grid backward, coarse group
        (65536, 112, 5466, "vec"),  # torso grid backward, fine group
        (655360, 224, 4096, "sorted"),  # spread or not, a wide call still sorts
    ],
)
def test_spread_rows_skip_smem(M, W, n_rows, want):
    """A caller whose rows spread evenly over the table (the torso grid)
    never gets ``smem``; the other rules stand."""
    assert pick_scatter_variant(M, W, n_rows, 4, True, spread=True) == want


@pytest.mark.parametrize(
    "n_rows,fits",
    [(SMEM_LIMIT // 16, True), (SMEM_LIMIT // 16 + 1, False)],
)
def test_smem_only_up_to_the_shared_memory_limit(n_rows, fits):
    """``[n_rows, 4]`` float32 is exactly the limit, then 16 bytes over."""
    M = 200 * n_rows
    assert scatter_variant_accepts("smem", M, 4, n_rows, 4, True) is fits
    assert (pick_scatter_variant(M, 4, n_rows, 4, True) == "smem") is fits
    if fits:
        blocks, copies, stride = smem_plan(M, 4, n_rows, 4, 132)
        assert copies == 1 and stride == n_rows * 4 and blocks == 132


@pytest.mark.parametrize(
    "M,W,n_rows",
    [(655360, 16, 324), (100000, 8, 1000), (5000, 6, 30), (64, 16, 2), (10**6, 4, 14528)],
)
def test_smem_plan_fits_and_spreads_copies(M, W, n_rows):
    blocks, copies, stride = smem_plan(M, W, n_rows, 2, 132)
    assert 1 <= blocks <= 132
    assert copies in (1, 2, 4, 8) and copies * stride * 4 <= SMEM_LIMIT
    assert stride >= n_rows * W
    if copies > 1:  # copies start one bank apart
        assert stride % 32 == 1


@pytest.mark.parametrize(
    "M,W,n_rows,aligned",
    [
        (655360, 5, 324, True),  # odd W
        (655360, 33, 5832, True),
        (655360, 16, 324, False),  # updates not on a 16-byte boundary
        (655360, 6, 65536, False),
        (0, 16, 324, True),  # nothing to add
    ],
)
def test_odd_width_or_unaligned_updates_take_atomic(M, W, n_rows, aligned):
    assert pick_scatter_variant(M, W, n_rows, 4, aligned) == "atomic"


def _unaligned(M, W):
    """Contiguous ``[M, W]`` float32 whose storage starts 4 bytes past a
    16-byte boundary."""
    base = torch.zeros(M * W + 4)
    shift = 1 + (-(base.data_ptr() // 4) % 4)  # floats to the next boundary, plus one
    upd = base[shift:shift + M * W].view(M, W)
    assert upd.is_contiguous() and upd.data_ptr() % 16 == 4
    return upd


@pytest.mark.parametrize(
    "variant,W,n_rows,unaligned",
    [
        ("runs", 16, 324, False),  # runs is compiled for W 2 and 6
        ("runs", 4, 324, False),
        ("vec", 5, 324, False),  # no whole 2-column vectors
        ("sorted", 7, 324, False),
        ("smem", 16, SMEM_LIMIT // 64 + 1, False),  # table beyond shared memory
        ("smem", 1026, 8, False),  # more column vectors than a block has threads
        ("vec", 16, 324, True),  # vector loads need aligned updates
        ("sorted", 16, 324, True),
        ("sorted", 16, SMEM_LIMIT // 4 + 1, False),  # one int per row in shared memory
        ("runs", 6, 324, True),
        ("nonesuch", 6, 324, False),  # no such variant
    ],
)
def test_forced_variant_that_does_not_take_the_shape_raises(variant, W, n_rows, unaligned):
    M = 64
    upd = _unaligned(M, W) if unaligned else torch.zeros(M, W)
    rows = torch.zeros(M, dtype=torch.int32)
    with pytest.raises(ValueError):
        launch_scatter_add_rows(rows, upd, n_rows, variant=variant)
    # without a forced variant the same call is taken (by ``atomic`` if need be)
    assert launch_scatter_add_rows(rows, upd, n_rows).shape == (n_rows, W)


@pytest.mark.parametrize("variant", VARIANTS)
def test_forced_variant_on_the_cpu_is_the_plain_version(variant):
    rng = np.random.RandomState(7)
    M, W, R = 500, 6, 40
    rows = torch.from_numpy(rng.randint(-3, R + 3, M).astype(np.int32))
    upd = torch.from_numpy(rng.randn(M, W).astype(np.float32))
    before = LAUNCHES["scatter_add_rows"]
    got = launch_scatter_add_rows(rows, upd, R, variant=variant)
    assert torch.equal(got, scatter_add_rows_plain(rows, upd, R))
    assert LAUNCHES["scatter_add_rows"] == before
