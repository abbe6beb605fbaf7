"""The fused grid backward (K1 per group, input gradients from the saved
rows) against ``jax.vjp`` of ``geneface_tpu.ops.fused_grid.fused_grid_encode``,
the dense view's adjoint, and the 3³ occupancy dilation.

Tolerances: table gradients are float32 sums of the same terms in another
order — rtol 1e-5, atol 1e-6·max|g|; input gradients sum products over
corners and levels in another order — rtol 1e-4, atol 1e-6·max|g|. The
dense view's adjoint and the max-pool are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneface_tpu.ops import encoders as jenc
from geneface_tpu.ops import fused_grid as jfg
from geneface_tpu.ops.morton import dilate_grid3d as jdilate
from geneface_tpu_torch.ops import (
    dense_view,
    dilate_grid3d,
    fused_grid_encode,
    make_fused_grid_meta,
    make_grid_meta,
)
from geneface_tpu_torch.ops.scatter import LAUNCHES


def _case(D, ungroup, interpolation, seed, M=2000):
    kw = dict(
        input_dim=D, num_levels=8, level_dim=4, base_resolution=16,
        log2_hashmap_size=12, desired_resolution=256, gridtype="tiled",
        interpolation=interpolation,
    )
    jmeta = jfg.make_fused_grid_meta(jenc.make_grid_meta(**kw), ungroup_coarse=ungroup)
    tmeta = make_fused_grid_meta(make_grid_meta(**kw), ungroup_coarse=ungroup)
    rng = np.random.RandomState(seed)
    shapes = jfg.init_fused_embeddings(jax.random.PRNGKey(0), jmeta)
    params = {
        k: rng.uniform(-1, 1, size=v.shape).astype(np.float32) for k, v in shapes.items()
    }
    x = rng.uniform(-0.05, 1.05, size=(M, D)).astype(np.float32)  # a few OOB
    gout = rng.randn(M, 8 * 4).astype(np.float32)
    return jmeta, tmeta, params, x, gout


def _close(got, ref, rtol):
    scale = float(np.abs(ref).max()) or 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-6 * scale)


@pytest.mark.parametrize(
    "D,ungroup,interp,need_input_grad",
    [
        (3, 0, "linear", False),
        (3, 0, "linear", True),
        (3, 3, "linear", False),
        (3, 3, "linear", True),
        (2, 0, "linear", True),
        (2, 4, "linear", True),
        (2, 0, "smoothstep", True),
    ],
)
def test_fused_grid_backward_matches_jax_vjp(D, ungroup, interp, need_input_grad):
    jmeta, tmeta, params, x, gout = _case(D, ungroup, interp, seed=D + ungroup)
    jx = jnp.asarray(x)
    _, vjp = jax.vjp(
        lambda xx, p: jfg.fused_grid_encode(xx, p, jmeta, need_input_grad), jx,
        {k: jnp.asarray(v) for k, v in params.items()},
    )
    jgx, jgp = vjp(jnp.asarray(gout))

    xt = torch.from_numpy(x).requires_grad_(need_input_grad)
    canon = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    tables = [
        dense_view(canon[f"group_{gi}"], tmeta, gi) if tmeta.modes[gi] == "dense"
        else canon[f"group_{gi}"]
        for gi in range(len(tmeta.groups))
    ]
    before = LAUNCHES["scatter_add_rows"]
    out = fused_grid_encode(xt, tables, tmeta, need_input_grad=need_input_grad)
    out.backward(torch.from_numpy(gout))
    assert LAUNCHES["scatter_add_rows"] == before  # CPU: the plain version
    for k in params:
        _close(canon[k].grad.numpy(), np.asarray(jgp[k]), rtol=1e-5)
    if need_input_grad:
        _close(xt.grad.numpy(), np.asarray(jgx), rtol=1e-4)
    else:
        assert xt.grad is None


def test_column_inputs_get_column_gradients():
    """The ambient grid feeds ``D`` coordinate columns (tuple inputs)."""
    jmeta, tmeta, params, x, gout = _case(2, 0, "linear", seed=5, M=700)
    cols = tuple(jnp.asarray(x[:, d]) for d in range(2))
    _, vjp = jax.vjp(
        lambda c: jfg.fused_grid_encode(c, {k: jnp.asarray(v) for k, v in params.items()}, jmeta),
        cols,
    )
    (jgc,) = vjp(jnp.asarray(gout))
    tc = tuple(torch.from_numpy(x[:, d].copy()).requires_grad_(True) for d in range(2))
    tables = [
        dense_view(torch.from_numpy(params[f"group_{gi}"]), tmeta, gi)
        if tmeta.modes[gi] == "dense" else torch.from_numpy(params[f"group_{gi}"])
        for gi in range(len(tmeta.groups))
    ]
    fused_grid_encode(tc, tables, tmeta).backward(torch.from_numpy(gout))
    for d in range(2):
        _close(tc[d].grad.numpy(), np.asarray(jgc[d]), rtol=1e-4)


@pytest.mark.parametrize("D,ungroup", [(3, 0), (2, 3)])
def test_dense_view_autograd_is_the_jax_adjoint(D, ungroup):
    jmeta, tmeta, params, _, _ = _case(D, ungroup, "linear", seed=11)
    rng = np.random.RandomState(3)
    for gi in range(len(tmeta.groups)):
        if tmeta.modes[gi] != "dense":
            continue
        canon = torch.from_numpy(params[f"group_{gi}"]).requires_grad_(True)
        view = dense_view(canon, tmeta, gi)
        gview = rng.randn(*view.shape).astype(np.float32)
        view.backward(torch.from_numpy(gview))
        ref = np.asarray(jfg._dense_view_adjoint(jnp.asarray(gview), jmeta, gi))
        np.testing.assert_allclose(canon.grad.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_dilate_grid3d_matches():
    rng = np.random.RandomState(0)
    g = rng.randn(2, 16, 16, 16).astype(np.float32)
    g[0, 3:5] = -1.0
    ref = np.asarray(jdilate(jnp.asarray(g)))
    np.testing.assert_array_equal(dilate_grid3d(torch.from_numpy(g)).numpy(), ref)
