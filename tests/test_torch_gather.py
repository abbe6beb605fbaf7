"""The port's row gather (K8) against the JAX probe's body, and the autograd
pair of K1 and K8.

Tolerances: a gather is a copy, so the plain version matches
``jnp.take(table, idx, axis=0)`` (the body of the Pallas probe
``tools/bench_pallas_scatter2.py:68`` and its reference ``:90``) exactly, in
float32 and from bfloat16 tables. The two autograd Functions are linear:
``gradcheck`` runs on float32 inputs holding small integers with a
perturbation of 0.5, where the central differences are exact, so it holds
them to atol 0, rtol 0. The wrappers take only the kernels' types (float64
is refused as on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneface_tpu_torch.ops.scatter import (
    LAUNCHES,
    gather_rows,
    gather_rows_plain,
    launch_gather_rows,
    scatter_add_rows,
)
from geneface_tpu_torch.ops.gather import pick_gather_path

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)


@pytest.mark.parametrize(
    "M,R,W,dtype",
    [
        (6144, 512, 128, np.float32),  # the probe's shapes, scaled down
        (4096, 324, 16, np.float32),
        (3000, 97, 224, "bfloat16"),
        (1000, 50, 6, "bfloat16"),
    ],
)
def test_gather_plain_matches_probe_take(M, R, W, dtype):
    rng = np.random.RandomState(M + W)
    idx = rng.randint(0, R, M).astype(np.int32)
    table32 = rng.randn(R, W).astype(np.float32)
    if dtype == "bfloat16":
        jt = jnp.asarray(table32).astype(jnp.bfloat16)
        tt = torch.from_numpy(table32).to(torch.bfloat16)
        ref = np.asarray(jnp.take(jt, jnp.asarray(idx), axis=0).astype(jnp.float32))
    else:
        tt = torch.from_numpy(table32)
        ref = np.asarray(jnp.take(jnp.asarray(table32), jnp.asarray(idx), axis=0))
    got = launch_gather_rows(tt, torch.from_numpy(idx))
    assert got.dtype == torch.float32 and got.shape == (M, W)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_gather_out_of_range_rows_are_zero_and_cpu_counts_no_launch():
    before = LAUNCHES["gather_rows"]
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3) + 1
    idx = torch.tensor([0, -1, 3, 4, 2, -7], dtype=torch.int32)
    got = launch_gather_rows(table, idx)
    want = np.zeros((6, 3), np.float32)
    want[[0, 2, 4]] = table.numpy()[[0, 3, 2]]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(gather_rows_plain(table, idx).numpy(), want)
    assert LAUNCHES["gather_rows"] == before


@pytest.mark.parametrize(
    "table,idx,err",
    [
        (torch.zeros(4, 2), torch.zeros(3, dtype=torch.int64), TypeError),
        (torch.zeros(4, 2, dtype=torch.float64), torch.zeros(3, dtype=torch.int32), TypeError),
        (torch.zeros(4), torch.zeros(3, dtype=torch.int32), ValueError),
        (torch.zeros(2, 4).T, torch.zeros(3, dtype=torch.int32), ValueError),
    ],
)
def test_gather_rejects_what_the_kernel_does_not_take(table, idx, err):
    with pytest.raises(err):
        launch_gather_rows(table, idx)


def _int_valued(rng, shape):
    return torch.from_numpy(rng.randint(-4, 5, size=shape).astype(np.float32))


def test_autograd_pair_gradcheck():
    rng = np.random.RandomState(0)
    rows = torch.from_numpy(rng.randint(-2, 7, 20).astype(np.int32))  # drops
    upd = _int_valued(rng, (20, 3)).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda u: scatter_add_rows(rows, u, 6), (upd,), eps=0.5, atol=0, rtol=0
    )
    table = _int_valued(rng, (6, 3)).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda t: gather_rows(t, rows), (table,), eps=0.5, atol=0, rtol=0
    )


def test_each_backward_is_the_other_forward():
    rng = np.random.RandomState(1)
    R, M, W = 9, 40, 5
    rows = torch.from_numpy(rng.randint(-3, R + 3, M).astype(np.int32))
    upd = torch.from_numpy(rng.randn(M, W).astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.randn(R, W).astype(np.float32))
    scatter_add_rows(rows, upd, R).backward(g)
    np.testing.assert_array_equal(upd.grad.numpy(), gather_rows(g, rows).numpy())

    table = torch.from_numpy(rng.randn(R, W).astype(np.float32)).requires_grad_(True)
    gm = torch.from_numpy(rng.randn(M, W).astype(np.float32))
    gather_rows(table, rows).backward(gm)
    np.testing.assert_array_equal(table.grad.numpy(), scatter_add_rows(rows, gm, R).numpy())
    # bfloat16 updates/tables get their gradients back in their own dtype
    ub = upd.detach().to(torch.bfloat16).requires_grad_(True)
    scatter_add_rows(rows, ub, R).sum().backward()
    assert ub.grad.dtype == torch.bfloat16


@pytest.mark.parametrize(
    "W,itemsize,table_ptr,out_ptr,want",
    [
        (224, 4, 0, 0, 4),  # W % 4 == 0, aligned: 16-byte vectors
        (8, 2, 8, 0, 4),  # a 16-bit table needs 8-byte alignment for 4 values
        (6, 4, 0, 0, 2),  # the composite's rows: three 8-byte vectors
        (2, 4, 512, 256, 2),
        (6, 2, 4, 0, 2),  # 4-byte loads from a 16-bit table
        (8, 4, 8, 0, 2),  # 16-byte vectors would be misaligned, 8-byte ones are not
        (8, 4, 0, 8, 2),  # ... the output too
        (5, 4, 0, 0, 1),  # odd W: scalar
        (8, 4, 4, 0, 1),  # table 4 bytes past a boundary: scalar
        (6, 2, 2, 0, 1),
    ],
)
def test_gather_path_choice(W, itemsize, table_ptr, out_ptr, want):
    assert pick_gather_path(W, itemsize, table_ptr, out_ptr) == want
