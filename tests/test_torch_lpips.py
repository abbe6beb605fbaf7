"""The port's LPIPS (``geneface_tpu_torch/models/lpips.py``) against
``geneface_tpu/models/lpips.py`` on JAX-initialized weights carried over by
``convert.lpips_state_dict``, with numpy-seeded images.

Tolerances: the distance within rtol 1e-5 (float32 convolutions summed in
another order); its gradient with respect to ``x`` within rtol 1e-4 and
atol 1e-5 × max |grad|: an entry sums the backward of every overlapping
11×11 window, where terms cancel, and against the port's float64 gradient
the JAX float32 one lies 3.5e-6 × max |grad| off and the port's float32 one
5.3e-6 × max (so 1e-6 × max would reject the reference itself).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneface_tpu.config import Config as JConfig
from geneface_tpu.models.lpips import LPIPS as JLPIPS
from geneface_tpu.models.lpips import lpips_params_from_npz as jfrom_npz
from geneface_tpu.tasks.radnerf import RADNeRFTask as JTask
from geneface_tpu_torch.convert import lpips_flax_params, lpips_state_dict
from geneface_tpu_torch.models.lpips import LPIPS, lpips_params_from_npz
from geneface_tpu_torch.tasks.radnerf import RADNeRFTask

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.convert_lpips_torch import convert_from_modules  # noqa: E402
from tools.make_synthetic_dataset import make_dataset  # noqa: E402

from test_torch_training import tiny_cfg  # noqa: E402


@pytest.fixture(scope="module")
def models():
    """JAX LPIPS params (one init; the weights do not depend on the image
    size), the jitted JAX distance and gradient per input range, and the
    port's module on the same weights per range."""
    x = jnp.zeros((1, 64, 64, 3))
    params = JLPIPS().init(jax.random.PRNGKey(0), x, x)
    sd = {k: torch.from_numpy(v) for k, v in lpips_state_dict(params).items()}
    out = {}
    for rng in ("unit", "pm1"):
        jm = JLPIPS(input_range=rng)
        tm = LPIPS(input_range=rng)
        tm.load_state_dict(sd)
        dist = jax.jit(jm.apply)
        grad = jax.jit(jax.grad(lambda p, a, b, m=jm: jnp.sum(m.apply(p, a, b)), argnums=1))
        out[rng] = (dist, grad, tm)
    return params, out


def _images(size, rng_name, seed):
    rs = np.random.RandomState(seed)
    x = rs.rand(2, size, size, 3).astype(np.float32)
    y = np.clip(x + 0.2 * rs.randn(2, size, size, 3), 0, 1).astype(np.float32)
    if rng_name == "pm1":
        x, y = 2 * x - 1, 2 * y - 1
    return x, y


@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("rng_name", ["unit", "pm1"])
def test_distance_matches(models, size, rng_name):
    params, fns = models
    dist, _, tm = fns[rng_name]
    x, y = _images(size, rng_name, seed=size)
    want = np.asarray(dist(params, jnp.asarray(x), jnp.asarray(y)))
    got = tm(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert want.shape == got.shape == (2,) and (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the distance of an image to itself is 0 on both sides
    assert float(tm(torch.from_numpy(x), torch.from_numpy(x)).abs().max()) < 1e-6


@pytest.mark.parametrize("rng_name", ["unit", "pm1"])
def test_gradient_wrt_x_matches(models, rng_name):
    params, fns = models
    _, grad, tm = fns[rng_name]
    x, y = _images(64, rng_name, seed=7)
    want = np.asarray(grad(params, jnp.asarray(x), jnp.asarray(y)))
    xt = torch.from_numpy(x).requires_grad_(True)
    tm(xt, torch.from_numpy(y)).sum().backward()
    got = xt.grad.numpy()
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)
    # the network is frozen: no parameter takes a gradient
    assert all(p.grad is None and not p.requires_grad for p in tm.parameters())


def test_npz_layout_reads_the_same_through_both_loaders(models, tmp_path):
    """One ``.npz`` in ``tools/convert_lpips_torch.py``'s layout (made by its
    ``convert_from_modules`` from torch ``Conv2d`` layers) gives the same
    distance through the JAX and the port's loaders."""
    params, fns = models
    src = LPIPS().reset_parameters(torch.Generator().manual_seed(3))
    convs = [getattr(src.alex, f"conv{i}") for i in range(5)]
    lins = [getattr(src, f"lin{i}").detach().reshape(1, -1, 1, 1) for i in range(5)]
    path = str(tmp_path / "lpips_alex.npz")
    np.savez(path, **convert_from_modules(convs, lins))

    tm = LPIPS()
    tm.load_state_dict({k: torch.from_numpy(v)
                        for k, v in lpips_state_dict(lpips_params_from_npz(path)).items()})
    for k, v in src.state_dict().items():
        torch.testing.assert_close(tm.state_dict()[k], v, rtol=0, atol=0)
    x, y = _images(48, "unit", seed=11)
    want = np.asarray(fns["unit"][0](jfrom_npz(path), jnp.asarray(x), jnp.asarray(y)))
    got = tm(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # and the port's tree maps back to the JAX layout
    back = lpips_flax_params(tm)["params"]
    np.testing.assert_array_equal(back["alex"]["conv0"]["kernel"],
                                  np.asarray(jfrom_npz(path)["params"]["alex"]["conv0"]["kernel"]))


def test_inputs_under_32_raise_on_both_sides(models):
    params, fns = models
    x = np.zeros((1, 31, 40, 3), np.float32)
    with pytest.raises(ValueError, match="32x32"):
        JLPIPS().apply(params, jnp.asarray(x), jnp.asarray(x))
    with pytest.raises(ValueError, match="32x32"):
        fns["unit"][2](torch.from_numpy(x), torch.from_numpy(x))


def test_missing_weights_guard_raises_on_both_sides(tmp_path):
    """``finetune_lips`` without ``lpips_weights`` or ``allow_random_lpips``
    raises the JAX guard's error in both tasks' ``build``."""
    data = str(tmp_path / "data")
    make_dataset(data, n_frames=4, hw=32)
    cfg = tiny_cfg(data, "", finetune_lips=True, lip_patch_size=32)
    with pytest.raises(ValueError, match="no LPIPS weights are configured") as want:
        JTask(JConfig(cfg)).build()
    with pytest.raises(ValueError, match="no LPIPS weights are configured") as got:
        RADNeRFTask(cfg, device="cpu").build()
    assert str(got.value) == str(want.value)
