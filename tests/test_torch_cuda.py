"""Card-only checks of the port: each CUDA kernel against its plain PyTorch
version, the autograd pair and the grid backward on the card against the
CPU, and a frame rendered on the card against the CPU plain path.

Imports no JAX, so it runs on a GPU host that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every test skips when CUDA is absent. Tolerances: float32 atomic sums in
another order — rtol 1e-5, atol 1e-4 (random updates) / exact for unique
rows; every scatter variant at the model's shapes — each sum of n terms
within 2·n·2⁻²⁴·Σ|u| of the plain version's, the first-order rounding bound
of two summation orders (up to 655,360 terms land on one row, where a fixed
atol would either fail or check nothing); a row gather is a copy — exact;
the grid forward (corner sums in another order) rtol 1e-6, atol 1e-7, at
the bf16 options too (the same bfloat16 roundings on both devices); the
grid backward's table gradients (atomic order) rtol 1e-5, atol 1e-6·max,
its input gradients rtol 1e-4, atol 1e-6·max (the reference and block
encoders of the import layout are held so too); a float32 frame (head, or
head+torso) on the card vs the CPU — 1e-5 absolute per pixel; the datagen
splat's weights and colours (K1 sums in another order) and its gradients
(K8 adjoint) 1e-5 of max, the datagen networks' outputs 1e-5 of max |CPU|
(TF32 off); the viewer's float32 frame at rungs 1.0 and 0.5, head and
head+torso — 1e-5 absolute per pixel, the uint8 frame within one level;
the vanilla NeRF's render (the CPU on the card's importance
samples) 1e-5 absolute per pixel, its gradients 1e-4 relative L2; two
gloo ranks sharing the card against one rank — each step's loss rel 1e-3,
its gradients 0.1 relative L2 (``chip_smoke.py``'s card bounds); the
native loader's pixels within one uint8 level of the numpy path's; a video
frame's rays and torso-over-background from the frame-inputs kernel —
exact, bit for bit against the host path (a last-bit ray direction moves a
sample across an occupancy cell edge).
"""

import os
import sys

import numpy as np
import pytest
import torch

from geneface_tpu_torch.ops import dense_view, fused_grid_encode, make_fused_grid_meta, make_grid_meta
from geneface_tpu_torch.ops.gather import pick_gather_path
from geneface_tpu_torch.ops.scatter import (
    LAUNCHES,
    VARIANTS,
    gather_rows,
    gather_rows_plain,
    launch_gather_rows,
    launch_scatter_add_rows,
    pick_scatter_variant,
    scatter_add_rows,
    scatter_add_rows_plain,
    scatter_variant_accepts,
)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

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


#: the scatter call sites of a 512² frame and a 65,536-ray training step
SITE_SHAPES = {
    "ambient_group_0": (655360, 16, 324),
    "position_group_1": (655360, 224, 4096),
    "ambient_group_1": (655360, 112, 5466),
    "position_group_0": (655360, 32, 5832),
    "serve_composite": (1081344, 6, 135168),
    "train_composite": (655360, 6, 65536),
    "frame_scatter": (135168, 6, 262144),
    "torso_group_0": (65536, 16, 324),
    "torso_group_1": (65536, 112, 5466),
    # the GeneFace import layouts (16 levels × 2) at a 65,536-ray step of
    # the padded slab (1,048,576 samples): the reference backend's capped
    # 3-D level (8 corners per sample), the block backend's capped 3-D and
    # finest dense 2-D local tables
    "reference_pos_capped_level": (8388608, 2, 65536),
    "block_pos_capped_level": (1048576, 16, 8192),
    "block_ambient_dense_level": (1048576, 8, 46656),
}


def _site_rows(pattern, M, R, card):
    gen = torch.Generator(device="cuda").manual_seed(M + R)
    if pattern == "random":
        return torch.randint(-3, R + 3, (M,), device=card, generator=gen).int()
    if pattern == "ray_major_holes":  # non-decreasing rows, -1 where a slot is empty
        per = -(-M // R)
        ray = (torch.arange(M, device=card) // per).int()
        hole = torch.rand(M, device=card, generator=gen) < 0.1
        return torch.where(hole, -1, ray).int()
    if pattern == "all_equal":  # the worst contention
        return torch.full((M,), R // 2, device=card, dtype=torch.int32)
    assert pattern == "all_dropped"
    return torch.where(torch.arange(M, device=card) % 2 == 0, -1, R).int()


def _assert_within_rounding_bound(got, rows, upd, R):
    ref = scatter_add_rows_plain(rows, upd, R)
    kept = (rows >= 0) & (rows < R)
    n = torch.bincount(rows[kept].long(), minlength=R).float()[:, None]
    bound = 2.0 * n * 2.0**-24 * scatter_add_rows_plain(rows, upd.abs(), R)
    bad = int(((got - ref).abs() > bound).sum())
    assert bad == 0, f"{bad} sums beyond the rounding bound, max {float((got - ref).abs().max())}"


@pytest.mark.parametrize("pattern", ["random", "ray_major_holes", "all_equal", "all_dropped"])
@pytest.mark.parametrize("site", list(SITE_SHAPES))
def test_every_scatter_variant_at_the_site_shapes(card, site, pattern):
    M, W, R = SITE_SHAPES[site]
    rows = _site_rows(pattern, M, R, card)
    gen = torch.Generator(device="cuda").manual_seed(W)
    upd32 = torch.randn(M, W, device=card, generator=gen)
    tried = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        upd = upd32.to(dtype)
        shape = (M, W, R, upd.element_size(), upd.data_ptr() % 16 == 0)
        assert scatter_variant_accepts(pick_scatter_variant(*shape), *shape)
        for variant in VARIANTS:
            if not scatter_variant_accepts(variant, *shape):
                continue
            before = LAUNCHES["scatter_add_rows"]
            got = launch_scatter_add_rows(rows, upd, R, variant=variant)
            torch.cuda.synchronize()
            assert LAUNCHES["scatter_add_rows"] == before + 1
            assert got.dtype == torch.float32 and got.shape == (R, W)
            _assert_within_rounding_bound(got, rows, upd, R)
            tried += 1
    assert tried >= 9  # atomic, vec and sorted take every one of these shapes


@pytest.mark.parametrize(
    "variant,W,R",
    [(v, W, R) for W, R in [(16, 324), (6, 65536), (224, 4096)] for v in VARIANTS
     if scatter_variant_accepts(v, 0, W, R, 4, True)],
)
def test_scatter_variant_with_no_updates(card, variant, W, R):
    rows = torch.zeros(0, dtype=torch.int32, device=card)
    upd = torch.zeros(0, W, device=card)
    got = launch_scatter_add_rows(rows, upd, R, variant=variant)
    torch.cuda.synchronize()
    assert got.shape == (R, W) and not got.any()


@pytest.mark.parametrize(
    "variant,N,C",
    [
        ("runs", 262144, 135168),  # the frame scatter's shape
        ("vec", 262144, 135168),
        ("atomic", 262144, 135168),
        ("sorted", 50000, 30000),  # sorted keeps one int per row in shared memory
    ],
)
def test_scatter_variants_on_unique_rows_are_bit_exact(card, variant, N, C):
    """Every kept row is hit once, so whatever merging a variant does finds
    nothing to merge and the result is a copy."""
    kept = C * 5 // 6
    idx = torch.full((C,), N, dtype=torch.int32)
    idx[:kept] = torch.randperm(N, generator=torch.Generator().manual_seed(0))[:kept].int()
    packed = torch.rand(C, 6, generator=torch.Generator().manual_seed(1))
    got = launch_scatter_add_rows(idx.to(card), packed.to(card), N, variant=variant).cpu()
    assert torch.equal(got, scatter_add_rows_plain(idx, packed, N))


def test_scatter_unaligned_updates_take_atomic(card):
    base = torch.randn(5000 * 16 + 1, device=card)
    upd = base[1:].view(5000, 16)  # contiguous, 4 bytes past an aligned row
    rows = torch.randint(0, 324, (5000,), dtype=torch.int32, device=card)
    assert pick_scatter_variant(5000, 16, 324, 4, upd.data_ptr() % 16 == 0) == "atomic"
    with pytest.raises(ValueError):
        launch_scatter_add_rows(rows, upd, 324, variant="vec")
    _assert_within_rounding_bound(launch_scatter_add_rows(rows, upd, 324), rows, upd, 324)
    # smem falls back to scalar loads on unaligned updates and stays right
    _assert_within_rounding_bound(
        launch_scatter_add_rows(rows, upd, 324, variant="smem"), rows, upd, 324)


def test_scatter_kernel_rejects_mixed_devices(card):
    with pytest.raises(ValueError):
        scatter_add_rows(torch.zeros(4, dtype=torch.int32), torch.zeros(4, 6, device=card), 3)


@pytest.mark.parametrize(
    "M,R,W,dtype",
    [
        (524288, 5832, 32, torch.float32),  # the training step's shapes
        (524288, 4096, 224, torch.float32),
        (131072, 5466, 112, torch.bfloat16),
        (70000, 324, 16, torch.float16),
        (262144, 324, 16, torch.float32),  # the torso grid at a 512² frame
        (262144, 5466, 112, torch.float32),
        (16384, 5466, 112, torch.float32),  # the torso sweep
        (1000, 50, 6, torch.float32),  # W % 4 != 0: the scalar path
        (0, 10, 8, torch.float32),  # no indices
        # the import layouts: the reference grid's corners of a capped 3-D
        # level (2 wide), the block grid's cells (bfloat16 fast tables)
        (17301504, 65536, 2, torch.float32),
        (2162688, 8192, 16, torch.bfloat16),
        (2162688, 46656, 8, torch.bfloat16),
    ],
)
def test_gather_kernel_matches_plain(card, M, R, W, dtype):
    rng = np.random.RandomState(M + W)
    idx = torch.from_numpy(rng.randint(-3, R + 3, M).astype(np.int32)).to(card)
    table = torch.from_numpy(rng.randn(R, W).astype(np.float32)).to(dtype).to(card)
    before = LAUNCHES["gather_rows"]
    got = launch_gather_rows(table, idx)
    torch.cuda.synchronize()
    assert LAUNCHES["gather_rows"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (M, W)
    assert torch.equal(got, gather_rows_plain(table, idx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("W", [6, 2])
def test_gather_kernel_two_wide_path_exact(card, W, dtype):
    """``W % 4 != 0``, ``W % 2 == 0``: 8-byte vectors (the composite's
    backward gather at ``W`` 6)."""
    rng = np.random.RandomState(W)
    R, M = 65536, 655360
    table = torch.from_numpy(rng.randn(R, W).astype(np.float32)).to(dtype).to(card)
    idx = torch.from_numpy(rng.randint(-3, R + 3, M).astype(np.int32)).to(card)
    got = launch_gather_rows(table, idx)
    torch.cuda.synchronize()
    assert pick_gather_path(W, table.element_size(), table.data_ptr(), got.data_ptr()) == 2
    assert torch.equal(got, gather_rows_plain(table, idx))


def test_gather_kernel_unaligned_table_takes_scalar_path(card):
    base = torch.randn(1000 * 8 + 1, device=card)
    table = base[1:].view(1000, 8)  # contiguous, 4 bytes past an aligned row
    idx = torch.randint(0, 1000, (5000,), dtype=torch.int32, device=card)
    assert torch.equal(launch_gather_rows(table, idx), gather_rows_plain(table, idx))


def test_autograd_pair_on_card_matches_cpu(card):
    rng = np.random.RandomState(0)
    R, M, W = 300, 20000, 12
    rows = torch.from_numpy(rng.randint(-2, R + 2, M).astype(np.int32))
    upd = torch.from_numpy(rng.randn(M, W).astype(np.float32))
    g = torch.from_numpy(rng.randn(R, W).astype(np.float32))
    grads = {}
    for dev in ("cpu", card):
        u = upd.clone().to(dev).requires_grad_(True)
        t = g.clone().to(dev).requires_grad_(True)
        before = dict(LAUNCHES)
        scatter_add_rows(rows.to(dev), u, R).backward(g.to(dev))
        gather_rows(t, rows.to(dev)).backward(upd.to(dev))
        torch.cuda.synchronize()
        if dev != "cpu":
            # each forward and each backward launched its kernel once
            assert LAUNCHES["scatter_add_rows"] == before["scatter_add_rows"] + 2
            assert LAUNCHES["gather_rows"] == before["gather_rows"] + 2
        grads[str(dev)] = (u.grad.cpu(), t.grad.cpu())
    assert torch.equal(grads["cuda"][0], grads["cpu"][0])
    torch.testing.assert_close(grads["cuda"][1], grads["cpu"][1], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("D,need_input_grad", [(3, False), (2, True)])
def test_grid_backward_on_card_matches_cpu(card, D, need_input_grad):
    meta = make_grid_meta(input_dim=D, num_levels=8, level_dim=4, log2_hashmap_size=14,
                          desired_resolution=2048, gridtype="tiled")
    fmeta = make_fused_grid_meta(meta)
    gen = torch.Generator().manual_seed(D)
    x = torch.rand(200000, D, generator=gen)
    params = [torch.rand(*((fmeta.dense_sides[gi] ** D, 4) if fmeta.modes[gi] == "dense"
                           else (fmeta.n_rows[gi], fmeta.group_width(gi))), generator=gen)
              for gi in range(len(fmeta.groups))]
    gout = torch.randn(200000, 32, generator=gen)
    res = {}
    for dev in ("cpu", card):
        xs = x.clone().to(dev).requires_grad_(need_input_grad)
        ps = [p.clone().to(dev).requires_grad_(True) for p in params]
        tables = [dense_view(p, fmeta, gi) if fmeta.modes[gi] == "dense" else p
                  for gi, p in enumerate(ps)]
        out = fused_grid_encode(xs, tables, fmeta, need_input_grad=need_input_grad)
        out.backward(gout.to(dev))
        res[str(dev)] = (out.detach().cpu(), [p.grad.cpu() for p in ps],
                         xs.grad.cpu() if need_input_grad else None)
    torch.testing.assert_close(res["cuda"][0], res["cpu"][0], rtol=1e-6, atol=1e-7)
    for a, b in zip(res["cuda"][1], res["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))
    if need_input_grad:
        b = res["cpu"][2]
        torch.testing.assert_close(res["cuda"][2], b, rtol=1e-4, atol=1e-6 * float(b.abs().max()))


#: the grid sites of the bf16 options (``grid_compute_dtype: bf16``): a
#: group's rows gathered from its bfloat16 table, its bfloat16 updates
#: scatter-added, at a 65,536-ray step's sample count
BF16_GRID_SITES = {
    "position_group_1": (655360, 224, 4096),
    "ambient_group_1": (655360, 112, 5466),
    "position_group_0": (655360, 32, 5832),
    "torso_group_1": (65536, 112, 5466),
}


@pytest.mark.parametrize("site", list(BF16_GRID_SITES))
def test_bf16_grid_sites_on_card_match_plain(card, site):
    M, W, R = BF16_GRID_SITES[site]
    gen = torch.Generator(device="cuda").manual_seed(M + W)
    table = torch.randn(R, W, device=card, generator=gen).to(torch.bfloat16)
    rows = torch.randint(0, R, (M,), device=card, generator=gen).int()
    before = dict(LAUNCHES)
    got = launch_gather_rows(table, rows)
    assert got.dtype == torch.float32 and torch.equal(got, gather_rows_plain(table, rows))
    upd = torch.randn(M, W, device=card, generator=gen).to(torch.bfloat16)
    sums = launch_scatter_add_rows(rows, upd, R)
    torch.cuda.synchronize()
    assert LAUNCHES["gather_rows"] == before["gather_rows"] + 1
    assert LAUNCHES["scatter_add_rows"] == before["scatter_add_rows"] + 1
    _assert_within_rounding_bound(sums, rows, upd, R)


@pytest.mark.parametrize("compute,bwd", [("bf16", "bf16"), ("mixed", "same"), ("f32", "bf16")])
def test_grid_options_on_card_match_cpu(card, compute, bwd):
    """The fused grid at the bf16 options on the card against the CPU (the
    f32 test's bounds: the same bfloat16 roundings, sums in another order)."""
    meta = make_grid_meta(input_dim=3, num_levels=8, level_dim=4, log2_hashmap_size=14,
                          desired_resolution=2048, gridtype="tiled")
    fmeta = make_fused_grid_meta(meta, compute=compute, bwd_compute=bwd)
    gen = torch.Generator().manual_seed(7)
    x = torch.rand(200000, 3, generator=gen)
    params = [torch.rand(*((fmeta.dense_sides[gi] ** 3, 4) if fmeta.modes[gi] == "dense"
                           else (fmeta.n_rows[gi], fmeta.group_width(gi))), generator=gen)
              for gi in range(len(fmeta.groups))]
    gout = torch.randn(200000, 32, generator=gen)
    res = {}
    for dev in ("cpu", card):
        xs = x.clone().to(dev).requires_grad_(True)
        ps = [p.clone().to(dev).requires_grad_(True) for p in params]
        tables = [dense_view(p, fmeta, gi) if fmeta.modes[gi] == "dense" else p
                  for gi, p in enumerate(ps)]
        out = fused_grid_encode(xs, tables, fmeta)
        out.backward(gout.to(dev))
        res[str(dev)] = (out.detach().cpu(), [p.grad.cpu() for p in ps], xs.grad.cpu())
    torch.testing.assert_close(res["cuda"][0], res["cpu"][0], rtol=1e-6, atol=1e-7)
    for a, b in zip(res["cuda"][1], res["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))
    b = res["cpu"][2]
    torch.testing.assert_close(res["cuda"][2], b, rtol=1e-4, atol=1e-6 * float(b.abs().max()))


@pytest.mark.parametrize("backend,D", [("reference", 3), ("reference", 2), ("block", 3),
                                       ("block", 2)])
def test_import_grid_encoders_on_card_match_cpu(card, backend, D):
    """The reference and block encoders at the import geometry (16 levels ×
    2, hashmap 2^16, finest resolution 2048), forward and both gradients
    end to end on the card against the CPU: one K8 launch per level
    forward, one K1 per level backward."""
    from geneface_tpu_torch.ops import encoders as E

    meta = E.make_grid_meta(input_dim=D, num_levels=16, level_dim=2, log2_hashmap_size=16,
                            desired_resolution=2048, gridtype="tiled")
    bmeta = E.make_block_grid_meta(meta)
    gen = torch.Generator().manual_seed(D)
    x = torch.rand(200000, D, generator=gen) * 1.02 - 0.01
    emb = torch.rand(meta.n_entries, 2, generator=gen) * 2 - 1
    gout = torch.randn(200000, 32, generator=gen)
    res = {}
    for dev in ("cpu", card):
        xs = x.clone().to(dev).requires_grad_(True)
        es = emb.clone().to(dev).requires_grad_(True)
        before = dict(LAUNCHES)
        if backend == "reference":
            out = E.grid_encode(xs, es, meta)
        else:
            out = E.fast_grid_encode(xs, es, bmeta)
        out.backward(gout.to(dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert LAUNCHES["gather_rows"] == before["gather_rows"] + 16
            assert LAUNCHES["scatter_add_rows"] == before["scatter_add_rows"] + 16
        res[str(dev)] = (out.detach().cpu(), es.grad.cpu(), xs.grad.cpu())
    torch.testing.assert_close(res["cuda"][0], res["cpu"][0], rtol=1e-6, atol=1e-7)
    b = res["cpu"][1]
    torch.testing.assert_close(res["cuda"][1], b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))
    b = res["cpu"][2]
    torch.testing.assert_close(res["cuda"][2], b, rtol=1e-4, atol=1e-6 * float(b.abs().max()))


def test_frame_on_card_matches_cpu(card, tmp_path):
    import chip_smoke
    from geneface_tpu_torch.inference import RADNeRFInfer

    cfg = chip_smoke.write_scene(str(tmp_path), hw=128, n_frames=4)
    cpu = RADNeRFInfer(cfg, device="cpu", dtype=torch.float32)
    gpu = RADNeRFInfer(cfg, device=card, dtype=torch.float32)
    cpu.prepare()
    before = dict(LAUNCHES)
    gpu.prepare()
    assert LAUNCHES["frame_inputs"] == before["frame_inputs"] + 4  # the capacity probes
    assert gpu.ray_capacity == cpu.ray_capacity is not None
    before = dict(LAUNCHES)
    got = gpu.render_frame(1)
    torch.cuda.synchronize()
    assert LAUNCHES["scatter_add_rows"] == before["scatter_add_rows"] + 2
    assert LAUNCHES["gather_rows"] == before["gather_rows"] + 4
    assert LAUNCHES["frame_inputs"] == before["frame_inputs"] + 1
    want = cpu.render_frame(1)
    assert torch.equal(got["n_samples"].cpu(), want["n_samples"])
    torch.testing.assert_close(got["rgb_map"].cpu(), want["rgb_map"], rtol=0, atol=1e-5)


def test_torso_frame_on_card_matches_cpu(card, tmp_path):
    import chip_smoke
    from geneface_tpu_torch.inference import RADNeRFInfer

    cfg = chip_smoke.torso_cfg(chip_smoke.write_scene(str(tmp_path), hw=128, n_frames=4))
    cpu = RADNeRFInfer(cfg, device="cpu", dtype=torch.float32)
    gpu = RADNeRFInfer(cfg, device=card, dtype=torch.float32)
    assert cpu.torso and gpu.torso
    cpu.prepare()
    before = dict(LAUNCHES)
    gpu.prepare()
    assert LAUNCHES["frame_inputs"] == before["frame_inputs"] + 4  # the capacity probes
    assert torch.equal(gpu.torso_mask.cpu(), cpu.torso_mask)
    before = dict(LAUNCHES)
    got = gpu.render_frame(1)
    torch.cuda.synchronize()
    assert LAUNCHES["scatter_add_rows"] == before["scatter_add_rows"] + 2
    assert LAUNCHES["gather_rows"] == before["gather_rows"] + 4 + 2  # head + torso groups
    assert LAUNCHES["frame_inputs"] == before["frame_inputs"] + 1
    want = cpu.render_frame(1)
    torch.testing.assert_close(got["rgb_map"].cpu(), want["rgb_map"], rtol=0, atol=1e-5)
    torch.testing.assert_close(got["torso_alpha_map"].cpu(), want["torso_alpha_map"],
                               rtol=0, atol=1e-5)


def _torso_plane(kind, H, W, rng):
    """A torso plane as a dataset may hold it (``dataset``: the file's own)."""
    return {
        "u8_rgba": lambda: rng.randint(0, 256, (H, W, 4)).astype(np.uint8),
        "u8_rgb": lambda: rng.randint(0, 256, (H, W, 3)).astype(np.uint8),
        "f32_rgba_unit": lambda: rng.rand(H, W, 4).astype(np.float32),
        "f32_rgb_255": lambda: (rng.rand(H, W, 3) * 255).astype(np.float32),
        "f64_rgba_255": lambda: rng.rand(H, W, 4) * 255,
    }[kind]()


def _random_poses(n, rng):
    """c2w poses of uniformly random rotations (the rotation chain's every
    sign and magnitude) at random centres."""
    out = []
    for _ in range(n):
        q = rng.randn(4)
        a, b, c, d = q / np.linalg.norm(q)
        P = np.eye(4, dtype=np.float32)
        P[:3, :3] = [[a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
                     [2 * (b * c + a * d), a * a - b * b + c * c - d * d, 2 * (c * d - a * b)],
                     [2 * (b * d - a * c), 2 * (c * d + a * b), a * a - b * b - c * c + d * d]]
        P[:3, 3] = rng.randn(3)
        out.append(P)
    out.append(np.eye(4, dtype=np.float32))  # exact zeros in the rotation
    return out


@pytest.mark.parametrize("planes", ["dataset", "u8_rgba", "u8_rgb", "f32_rgba_unit",
                                    "f32_rgb_255", "f64_rgba_255"])
def test_frame_inputs_kernel_is_the_host_path_bit_for_bit(card, tmp_path, planes):
    """Every pose of a 512² dataset (and random rotations at other
    intrinsics): the kernel's rays and torso-over-background equal
    ``get_rays`` and ``RADNeRFDataset._bg_torso`` (``__getitem__``) bit
    for bit, and the rays alone equal the rays with the plane."""
    import chip_smoke

    from geneface_tpu_torch.data.radnerf_dataset import RADNeRFDataset
    from geneface_tpu_torch.ops.frame_inputs import frame_inputs
    from geneface_tpu_torch.tools.make_synthetic_dataset import make_dataset
    from geneface_tpu_torch.utils.camera import get_rays

    data = str(tmp_path / "data")
    make_dataset(data, n_frames=8, hw=512, seed=0)
    ds = RADNeRFDataset("trainval", data, chip_smoke.production_cfg(data, str(tmp_path)))
    bg = torch.as_tensor(ds.bg_img.reshape(-1, 3), device=card)
    rng = np.random.RandomState(7)

    def bits(x):
        x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        assert x.dtype == np.float32
        return x.view(np.int32)

    for i in range(len(ds)):
        sample = ds.samples[i]
        if planes != "dataset":
            sample["torso_img"] = _torso_plane(planes, ds.H, ds.W, rng)
        item = ds[i]
        before = LAUNCHES["frame_inputs"]
        o, d, b = frame_inputs(ds.poses[i], ds.intrinsics, ds.H, ds.W, card,
                               sample["torso_img"], bg)
        o2, d2, none = frame_inputs(ds.poses[i], ds.intrinsics, ds.H, ds.W, card)
        torch.cuda.synchronize()
        assert LAUNCHES["frame_inputs"] == before + 2 and none is None
        for got, want in ((o, item["rays_o"]), (d, item["rays_d"]), (b, item["bg_torso_img"]),
                          (o2, item["rays_o"]), (d2, item["rays_d"])):
            diff = bits(got) != bits(want)
            assert not diff.any(), (i, int(diff.sum()))
    for k, pose in enumerate(_random_poses(8, rng)):
        intr = (900.0 + 700 * rng.rand(), 900.0 + 700 * rng.rand(), 200 + 100 * rng.rand(),
                200 + 100 * rng.rand())
        want = get_rays(pose, intr, 384, 640)
        o, d, _ = frame_inputs(pose, intr, 384, 640, card)
        for got, ref in ((o, want["rays_o"]), (d, want["rays_d"])):
            diff = bits(got) != bits(ref)
            assert not diff.any(), (k, int(diff.sum()))


@pytest.mark.parametrize("torso", [False, True], ids=["head", "torso"])
@pytest.mark.parametrize("rung", [1.0, 0.5])
def test_viewer_frame_on_card_matches_cpu(card, tmp_path, torso, rung):
    """``RealtimeRenderer.render`` at an orbit pose, a ladder rung, knob
    overrides and individual code 1, on the card against the CPU."""
    import chip_smoke
    from geneface_tpu_torch.inference import OrbitCamera, RADNeRFInfer, RealtimeRenderer

    cfg = chip_smoke.write_scene(str(tmp_path), hw=128, n_frames=4)
    cfg = chip_smoke.torso_cfg(cfg) if torso else cfg
    out = {}
    for dev in (card, "cpu"):
        r = RealtimeRenderer(RADNeRFInfer(cfg, device=dev, dtype=torch.float32))
        r.downscale_override, r.ind_index, r.cond_index = rung, 1, 2
        r.max_steps, r.t_thresh = 12, 1e-3
        ds = r.ds
        cam = OrbitCamera(ds.W, ds.H)
        cam.update_intrinsics(ds.intrinsics)
        cam.update_pose(np.asarray(ds.poses[0]))
        cam.orbit(30.0, -10.0)
        before = dict(LAUNCHES)
        frame = r.render(cam)
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        out[str(dev)] = (frame, r.infer.last_render["rgb_map"].cpu(), launched)
    (gf, grgb, glaunch), (cf, crgb, claunch) = out["cuda"], out["cpu"]
    assert gf.shape == (int(128 * rung) // 8 * 8,) * 2 + (3,)
    assert glaunch["scatter_add_rows"] >= 1 and glaunch["gather_rows"] >= 4
    assert claunch == {k: 0 for k in LAUNCHES}
    torch.testing.assert_close(grgb, crgb, rtol=0, atol=1e-5)
    assert np.abs(gf.astype(int) - cf.astype(int)).max() <= 1


def test_clip_gathers_on_card_match_cpu(card):
    """Stage A's clip gathers (K8) and the mouth clips' adjoint (K1) on the
    card: the clips exact, the mouth gradient within the float32 rounding
    of two summation orders (clips overlap in frames)."""
    from geneface_tpu_torch.tasks.syncnet import gather_clips, mine_sync_clips

    rng = np.random.RandomState(0)
    B, T = 12, 96
    mouth = torch.from_numpy(rng.randn(B, T, 60).astype(np.float32))
    hubert = torch.from_numpy(rng.randn(B, 2 * T, 1024).astype(np.float32))
    idx = mine_sync_clips(rng.randint(40, T + 1, B), 64, np.random.RandomState(1))[:4]
    w = torch.from_numpy(rng.randn(64, 5, 60).astype(np.float32))
    out = {}
    for dev in (card, torch.device("cpu")):
        m = mouth.to(dev).requires_grad_(True)
        before = dict(LAUNCHES)
        mc, hc = gather_clips(m, hubert.to(dev), *idx)
        (mc * w.to(dev)).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert LAUNCHES["gather_rows"] - before["gather_rows"] == 2
            assert LAUNCHES["scatter_add_rows"] - before["scatter_add_rows"] == 1
        out[dev.type] = (mc.detach().cpu(), hc.cpu(), m.grad.cpu())
    for a, b in zip(out["cuda"][:2], out["cpu"][:2]):
        assert torch.equal(a, b)
    torch.testing.assert_close(out["cuda"][2], out["cpu"][2], rtol=1e-5, atol=1e-5)


def test_face_splat_on_card_matches_cpu(card):
    """The datagen renderer's two K1 sites (normals, splat) and their K8
    adjoints on the card: one launch each way per site; the render and the
    photometric loss's gradients against the CPU plain path."""
    from torch_datagen_helpers import smooth_track, sphere_cap, torch_full_basis

    from geneface_tpu_torch.datagen import face_renderer as R
    from geneface_tpu_torch.datagen.face_tracker import _cam_geometry

    rng = np.random.RandomState(0)
    b = torch_full_basis(sphere_cap(rng, nu=120, nv=120))
    tr = smooth_track(rng, 4, 6, 4)
    cam = _cam_geometry(b, *(torch.as_tensor(tr[k]) for k in ("id", "exp", "euler", "trans")))
    light = torch.from_numpy((rng.randn(4, 27) * 0.2).astype(np.float32))
    target = torch.from_numpy(rng.rand(4, 64, 64, 3).astype(np.float32))
    cxy = torch.tensor([128.0, 128.0])
    out = {}
    for dev in (card, torch.device("cpu")):
        c = cam.to(dev).requires_grad_(True)
        g = light.to(dev).requires_grad_(True)
        before = dict(LAUNCHES)
        albedo = b.tex_mean.to(dev).reshape(1, -1, 3)
        colors = albedo * R.sh9_irradiance(R.vertex_normals(c, b.tris.to(dev)), g)
        rgb, w = R.render_vertices_soft(c, colors, 500.0, cxy.to(dev), 256, 256, scale=4)
        R.photometric_loss(rgb, w, target.to(dev)).backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert LAUNCHES["scatter_add_rows"] - before["scatter_add_rows"] == 2
            assert LAUNCHES["gather_rows"] - before["gather_rows"] == 2
        out[dev.type] = [t.detach().cpu() for t in (rgb, w, c.grad, g.grad)]
    assert float(out["cpu"][1].max()) > 0.5  # the face covers pixels
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("name", ["bisenet", "fan", "recon"])
def test_datagen_nets_on_card_match_cpu(card, name):
    from geneface_tpu_torch.datagen.face_landmarker import FAN
    from geneface_tpu_torch.datagen.face_parser import BiSeNet
    from geneface_tpu_torch.datagen.face_recon import ReconNet
    from geneface_tpu_torch.models.layers import init_weights_

    from geneface_tpu_torch import set_full_fp32

    set_full_fp32()
    model, side = {"bisenet": (BiSeNet, 128), "fan": (FAN, 256), "recon": (ReconNet, 224)}[name]
    net = init_weights_(model(), torch.Generator().manual_seed(0)).eval()
    x = torch.rand(2, side, side, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = net(x)
        got = net.to(card)(x.to(card)).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_landmark_fit_on_card_picks_the_cpu_focal(card):
    from torch_datagen_helpers import smooth_track, sphere_cap, torch_lm_basis

    from geneface_tpu_torch.datagen.face_tracker import fit_sequence, project_landmarks

    rng = np.random.RandomState(0)
    basis = torch_lm_basis(sphere_cap(rng))
    tr = smooth_track(rng, 12, 6, 4)
    lms = project_landmarks(basis, *(torch.as_tensor(tr[k]) for k in ("id", "exp", "euler",
                                                                        "trans")),
                            700.0, torch.tensor([256.0, 256.0])).numpy()
    kw = dict(coarse_steps=60, refine_steps=60, coarse_every=4)
    got = fit_sequence(lms, basis, 512, 512, device="cuda", **kw)
    want = fit_sequence(lms, basis, 512, 512, device="cpu", **kw)
    assert got["focal"] == want["focal"] == 700.0
    np.testing.assert_allclose(got["trans"], want["trans"], rtol=1e-3, atol=1e-4)


def test_vanilla_render_on_card_matches_cpu(card):
    """The vanilla coarse+fine render of a small ``Lm3dNeRF`` on the card,
    jittered, against the CPU on the card's importance samples: pixels
    within 1e-5 absolute, and the field's gradient within 1e-4 relative L2
    (TF32 off)."""
    from geneface_tpu_torch import set_full_fp32
    from geneface_tpu_torch.models.nerf import Lm3dNeRF
    from geneface_tpu_torch.ops.volume import render_rays

    set_full_fp32()
    rng = np.random.RandomState(0)
    N = 512
    o = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (N, 1))
    d = np.stack([rng.randn(N) * 0.2, rng.randn(N) * 0.2, -np.ones(N)], -1).astype(np.float32)
    bg = rng.rand(N, 3).astype(np.float32)
    t_rand, u = rng.rand(N, 16).astype(np.float32), rng.rand(N, 32).astype(np.float32)
    cond = rng.randn(5, 1, 204).astype(np.float32)
    cpu = Lm3dNeRF(204, cond_dim=32, hidden_size=64)
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    gpu = Lm3dNeRF(204, cond_dim=32, hidden_size=64).to(card)
    gpu.load_state_dict(cpu.state_dict())
    outs, grads = [], []
    for model, dev in ((gpu, card), (cpu, torch.device("cpu"))):
        t = {k: torch.as_tensor(v, device=dev) for k, v in
             dict(o=o, d=d, bg=bg, t_rand=t_rand, u=u, cond=cond).items()}
        feat = model.cal_cond_feat(t["cond"], True)
        vd = t["d"] / torch.linalg.norm(t["d"], dim=-1, keepdim=True)
        out = render_rays(lambda p, fine: model(p, feat, vd, fine), t["o"], t["d"], 0.3, 0.9,
                          t["bg"], 16, 32, t_rand=t["t_rand"], u=t["u"],
                          z_samples=outs[0]["z_samples"].to(dev) if outs else None)
        (out["rgb_map"].sum() + out["rgb_map_coarse"].sum()).backward()
        outs.append(out)
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    np.testing.assert_allclose(outs[0]["rgb_map"].detach().cpu().numpy(),
                               outs[1]["rgb_map"].detach().numpy(), atol=1e-5, rtol=0)
    for n, g in grads[1].items():
        err = float(torch.linalg.norm(grads[0][n] - g) / torch.linalg.norm(g).clamp_min(1e-30))
        assert err < 1e-4, (n, err)


def test_deepspeech_on_card_matches_cpu(card):
    """DeepSpeech at narrow widths (494→256→256→256, cell 256) over 200
    frames on the card against the CPU: logits within 1e-5 of max |CPU|
    (TF32 off; the LSTM carries the products' other summation order across
    the frames)."""
    from geneface_tpu_torch import set_full_fp32
    from geneface_tpu_torch.datagen.deepspeech import DeepSpeechNet
    from geneface_tpu_torch.models.layers import init_weights_

    set_full_fp32()
    net = init_weights_(DeepSpeechNet(494, 256, 256, 29), torch.Generator().manual_seed(0))
    with torch.no_grad():
        k = net.lstm_kernel
        k.copy_(torch.randn(k.shape, generator=torch.Generator().manual_seed(1)) / 23.0)
    x = torch.randn(200, 494, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = net.eval()(x)
        got = net.to(card)(x.to(card)).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_audio2pose_on_card_matches_cpu(card):
    """The audio2pose model's forward and gradient on a batch of 2 × 40
    frames, and a 12-frame rollout, on the card against the CPU: within
    1e-5 of max |CPU| and 1e-4 relative L2 (TF32 off)."""
    from geneface_tpu_torch import set_full_fp32
    from geneface_tpu_torch.models.audio2pose import (
        Audio2PoseModel,
        autoregressive_infer,
        gmm_log_loss,
    )
    from geneface_tpu_torch.models.layers import init_weights_

    set_full_fp32()
    gen = torch.Generator().manual_seed(0)
    cpu = init_weights_(Audio2PoseModel(recept_field=16), gen)
    gpu = Audio2PoseModel(recept_field=16).to(card)
    gpu.load_state_dict(cpu.state_dict())
    audio = torch.randn(2, 40, 58, generator=gen)
    pv = torch.randn(2, 41, 12, generator=gen) * 0.1
    outs, grads = [], []
    for model, dev in ((gpu, card), (cpu, torch.device("cpu"))):
        out = model(audio.to(dev), pv[:, :-1].to(dev))
        gmm_log_loss(out, pv[:, 1:].to(dev)).backward()
        outs.append(out.detach().cpu())
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None})
    torch.testing.assert_close(outs[0], outs[1], rtol=0,
                               atol=1e-5 * float(outs[1].abs().max()))
    for n, g in grads[1].items():
        assert float(torch.linalg.norm(grads[0][n] - g) / torch.linalg.norm(g)) <= 1e-4, n
    poses = [autoregressive_infer(m, audio[0, :12].to(m.audio_fc1.weight.device),
                                  init_pose=np.full(6, 0.05, np.float32)).cpu()
             for m in (gpu, cpu)]
    torch.testing.assert_close(poses[0], poses[1], rtol=0,
                               atol=1e-5 * float(poses[1].abs().max()))


def test_two_rank_gloo_steps_on_card_match_one_rank(card, tmp_path):
    """Two gloo ranks sharing ``cuda:0`` (``tests/torch_ddp_helpers.py``)
    against one rank on the card: 3 head steps of 2,048 rays at float32
    MLPs, the sweep at step 0 — each step's loss within rel 1e-3 and every
    gradient within relative L2 0.1 (the bounds of ``chip_smoke.py``'s
    card checks: atomic order and the halved batches regroup sums), the
    ranks' gradients equal, both kernels launched in the one-rank run."""
    import chip_smoke
    import torch_ddp_helpers as ddp

    from geneface_tpu_torch.data.radnerf_dataset import RADNeRFDataset

    cfg = chip_smoke.train_cfg(chip_smoke.write_scene(str(tmp_path), hw=128, n_frames=4))
    cfg.update(n_rays=2048, update_extra_interval=16)
    ds = RADNeRFDataset("train", cfg["data_dir"], cfg, training=True)
    case = dict(kind="head", cfg=cfg, batches=[ds[i] for i in range(3)], device="cuda:0")
    r0, r1 = (r["head"] for r in ddp.run_ranks("steps", {"cases": {"head": case}}, 2,
                                              str(tmp_path / "ranks"), device="cuda:0"))
    before = dict(LAUNCHES)
    one = ddp.step_result(**case)
    assert all(LAUNCHES[k] > before[k] for k in ("scatter_add_rows", "gather_rows"))
    for s, (l1, l2) in enumerate(zip(one["losses"], r0["losses"])):
        assert abs(l2["total_loss"] - l1["total_loss"]) <= 1e-3 * abs(l1["total_loss"]), s
        for name, g in one["grads"][s].items():
            err = np.linalg.norm(r0["grads"][s][name] - g) / max(np.linalg.norm(g), 1e-30)
            assert err <= 0.1, (s, name, err)
            np.testing.assert_array_equal(r1["grads"][s][name], r0["grads"][s][name])
    for a, b in zip(r0["occ"], r1["occ"]):
        np.testing.assert_array_equal(a, b)


def test_native_loader_feeds_a_card_step(card, tmp_path):
    """The default (native) batches train a step on the card, and agree with
    the numpy path's within one uint8 level."""
    import chip_smoke

    from geneface_tpu_torch.tasks.radnerf import RADNeRFTask

    cfg = chip_smoke.train_cfg(chip_smoke.write_scene(str(tmp_path), hw=128, n_frames=4))
    cfg.update(n_rays=4096, native_loader=True)
    task = RADNeRFTask(cfg, device=card, dtype=torch.float32)
    task.build()
    assert task.train_ds.native_loader is not None
    batch = task.train_ds[1]
    numpy_ds = type(task.train_ds)("train", cfg["data_dir"], dict(cfg, native_loader=False),
                                   training=True)
    ref = numpy_ds[1]
    np.testing.assert_array_equal(batch["inds"], ref["inds"])
    for k in ("gt_img_u8", "bg_img_u8", "bg_torso_img_u8"):
        assert np.abs(batch[k].astype(np.int16) - ref[k]).max() <= 1, k
    before = dict(LAUNCHES)
    out = task.train_step(batch)
    torch.cuda.synchronize()
    assert np.isfinite(float(out["total_loss"]))
    assert all(LAUNCHES[k] > before[k] for k in ("scatter_add_rows", "gather_rows"))


def test_tsne_on_card_matches_cpu(card):
    """``tsne``'s default device is the card: its float64 descent there
    against the CPU's on the input of ``test_torch_utils_misc.py``, within
    the 1e-9 of the embedding's magnitude that file holds it to against the
    JAX one after 10 iterations."""
    from geneface_tpu_torch.utils import visualization

    rng = np.random.RandomState(0)
    x = np.concatenate([rng.normal(0, 0.05, (40, 8)), rng.normal(3, 0.05, (40, 8))])
    want = visualization.tsne(x, perplexity=10, n_iter=10, seed=0, device="cpu")
    got = visualization.tsne(x, perplexity=10, n_iter=10, seed=0)
    assert got.dtype == np.float32 and got.shape == (80, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())
