"""Card-only checks of the port: each CUDA kernel against its plain PyTorch
version, and a frame rendered on the card against the CPU plain path.

Imports no JAX, so it runs on a GPU host that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every test skips when CUDA is absent. Tolerances: float32 atomic sums in
another order — rtol 1e-5, atol 1e-4 (random updates) / exact for unique
rows; a float32 frame on the card vs the CPU — 1e-5 absolute per pixel.
"""

import os
import sys

import numpy as np
import pytest
import torch

from geneface_tpu_torch.ops.scatter import (
    LAUNCHES,
    scatter_add_rows,
    scatter_add_rows_plain,
)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "M,R,W,dtype",
    [
        (300000, 40000, 6, torch.float32),
        (65536, 5000, 32, torch.bfloat16),
        (4096, 7, 128, torch.float16),  # collision-heavy
        (0, 10, 6, torch.float32),  # empty update stream
    ],
)
def test_scatter_kernel_matches_plain(card, M, R, W, dtype):
    rng = np.random.RandomState(M + W)
    rows = torch.from_numpy(rng.randint(-5, R + 5, M).astype(np.int32)).to(card)
    upd = torch.from_numpy(rng.randn(M, W).astype(np.float32)).to(dtype).to(card)
    before = LAUNCHES["scatter_add_rows"]
    got = scatter_add_rows(rows, upd, R)
    torch.cuda.synchronize()
    assert LAUNCHES["scatter_add_rows"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (R, W)
    torch.testing.assert_close(got, scatter_add_rows_plain(rows, upd, R), rtol=1e-5, atol=1e-4)


def test_scatter_kernel_unique_rows_exact(card):
    N, C = 262144, 90000
    idx = torch.full((C,), N, dtype=torch.int32)
    idx[:80000] = torch.randperm(N, generator=torch.Generator().manual_seed(0))[:80000].int()
    packed = torch.rand(C, 6, generator=torch.Generator().manual_seed(1))
    got = scatter_add_rows(idx.to(card), packed.to(card), N).cpu()
    assert torch.equal(got, scatter_add_rows_plain(idx, packed, N))


def test_scatter_kernel_rejects_mixed_devices(card):
    with pytest.raises(ValueError):
        scatter_add_rows(torch.zeros(4, dtype=torch.int32), torch.zeros(4, 6, device=card), 3)


def test_frame_on_card_matches_cpu(card, tmp_path):
    import chip_smoke
    from geneface_tpu_torch.inference import RADNeRFInfer

    cfg = chip_smoke.write_scene(str(tmp_path), hw=128, n_frames=4)
    cpu = RADNeRFInfer(cfg, device="cpu", dtype=torch.float32)
    gpu = RADNeRFInfer(cfg, device=card, dtype=torch.float32)
    cpu.prepare()
    gpu.prepare()
    assert gpu.ray_capacity == cpu.ray_capacity is not None
    before = LAUNCHES["scatter_add_rows"]
    got = gpu.render_frame(1)
    torch.cuda.synchronize()
    assert LAUNCHES["scatter_add_rows"] == before + 2
    want = cpu.render_frame(1)
    assert torch.equal(got["n_samples"].cpu(), want["n_samples"])
    torch.testing.assert_close(got["rgb_map"].cpu(), want["rgb_map"], rtol=0, atol=1e-5)
