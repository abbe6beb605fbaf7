"""A video frame's inputs (``ops/frame_inputs.py``) on the CPU: the host
path gives bit for bit what ``RADNeRFDataset.__getitem__`` gives (the rays
of ``get_rays``, the torso over the background of ``_bg_torso``) for every
pose and each kind of torso plane; ``RADNeRFInfer.render_frame`` feeds the
renderer what it fed it from the dataset item, head and torso checkpoints;
``prepare()`` probes the same ray capacity and torso mask; and the wrapper
refuses on every device what the kernel would. The kernel against this
host path is ``tests/test_torch_cuda.py``'s.
"""

import os
import sys

import numpy as np
import pytest
import torch

from geneface_tpu_torch.data.radnerf_dataset import get_cond_window
from geneface_tpu_torch.inference import RADNeRFInfer
from geneface_tpu_torch.inference.radnerf_infer import pick_ray_capacity
from geneface_tpu_torch.kernels import LAUNCHES
from geneface_tpu_torch.models.radnerf import kdop_hit, torso_occupancy_mask
from geneface_tpu_torch.ops.frame_inputs import (
    frame_inputs,
    frame_inputs_plain,
    launch_frame_inputs,
)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)

HW = 96  # the smallest frame where the ray cull engages (4,096-ray capacity steps)
N_FRAMES = 6


def _plane(kind: str, rng: np.random.RandomState) -> np.ndarray:
    """A torso plane as a dataset may hold it."""
    if kind == "u8_rgba":
        return rng.randint(0, 256, (HW, HW, 4)).astype(np.uint8)
    if kind == "u8_rgb":
        return rng.randint(0, 256, (HW, HW, 3)).astype(np.uint8)
    if kind == "f32_rgba_unit":  # largest value under 1.5: not scaled
        return rng.rand(HW, HW, 4).astype(np.float32)
    if kind == "f32_rgb_255":
        return (rng.rand(HW, HW, 3) * 255).astype(np.float32)
    if kind == "f64_rgba_255":
        return rng.rand(HW, HW, 4) * 255
    if kind == "u8_rgba_binary":  # a uint8 plane of 0s and 1s: not scaled
        return rng.randint(0, 2, (HW, HW, 4)).astype(np.uint8)
    raise ValueError(kind)


PLANES = ["u8_rgba", "u8_rgb", "f32_rgba_unit", "f32_rgb_255", "f64_rgba_255", "u8_rgba_binary"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("frame_inputs"))
    return chip_smoke.write_scene(root, hw=HW, n_frames=N_FRAMES)


def _infer(cfg, torso: bool, planes: str | None = None) -> RADNeRFInfer:
    inf = RADNeRFInfer(chip_smoke.torso_cfg(cfg) if torso else cfg, device="cpu",
                       dtype=torch.float32)
    if planes is not None:
        rng = np.random.RandomState(len(planes))
        for s in inf.dataset.samples:
            s["torso_img"] = _plane(planes, rng)
    return inf


def _bits(x) -> bytes:
    x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
    assert x.dtype == np.float32
    return np.ascontiguousarray(x).tobytes()


@pytest.fixture(scope="module")
def head(scene):
    return _infer(scene, False)


@pytest.mark.parametrize("planes", [None] + PLANES)
def test_host_path_is_the_dataset_item(head, planes):
    """Every pose, with the dataset's own plane (uint8 RGBA) or a planted
    one: the rays and the composite are the item's, bit for bit."""
    ds = head.dataset
    bg = torch.as_tensor(ds.bg_img.reshape(-1, 3))
    rng = np.random.RandomState(3)
    for i in range(len(ds)):
        sample = ds.samples[i]
        saved = sample["torso_img"]  # the module's fixture is shared: put it back
        plane = sample["torso_img"] = saved if planes is None else _plane(planes, rng)
        try:
            item = ds[i]
        finally:
            sample["torso_img"] = saved
        rays_o, rays_d, bg_torso = frame_inputs(ds.poses[i], ds.intrinsics, ds.H, ds.W,
                                                "cpu", plane, bg)
        assert _bits(rays_o) == _bits(item["rays_o"])
        assert _bits(rays_d) == _bits(item["rays_d"])
        assert _bits(bg_torso) == _bits(item["bg_torso_img"])
        o, d, none = frame_inputs(ds.poses[i], ds.intrinsics, ds.H, ds.W, "cpu")
        assert none is None and _bits(o) == _bits(rays_o) and _bits(d) == _bits(rays_d)


@pytest.mark.parametrize("torso", [False, True], ids=["head", "torso"])
@pytest.mark.parametrize("planes", [None, "u8_rgb", "f32_rgba_unit"])
def test_render_frame_feeds_the_renderer_the_item(scene, torso, planes):
    """``render_frame`` hands ``render_rays`` the item's rays, background
    (the torso over the background for the head, the plain background under
    the torso), screen coordinates, window and pose, bit for bit."""
    inf = _infer(scene, torso, planes)
    inf.prepare()
    seen = []
    inf.render_rays = lambda *args, **kw: seen.append((args, kw))
    ds = inf.dataset
    for i in (1, len(ds) + 2):  # past the dataset: its poses loop
        inf.render_frame(i)
        args, kw = seen[-1]
        item = ds[i % len(ds)]
        assert _bits(args[0]) == _bits(item["rays_o"])
        assert _bits(args[1]) == _bits(item["rays_d"])
        bg = item["bg_img"] if torso else item["bg_torso_img"]
        assert _bits(args[2]) == _bits(bg)
        if torso:
            assert _bits(args[3]) == _bits(item["bg_coords"])
        else:
            assert args[3] is None
        np.testing.assert_array_equal(args[4], get_cond_window(ds.conds, i, scene["smo_win_size"]))
        assert _bits(args[5]) == _bits(item["pose"]) and args[6] == 0
        assert kw["ray_capacity"] == inf.ray_capacity and kw["cull_kdop"] is inf.cull_kdop
        assert kw["torso_mask"] is inf.torso_mask


@pytest.mark.parametrize("torso", [False, True], ids=["head", "torso"])
def test_prepare_probes_as_the_dataset_items_did(scene, torso, monkeypatch):
    """The ray capacity from the four probe poses' rays (rays alone, one
    call a pose), and the torso mask over the screen coordinates, as
    ``prepare()`` found them from the dataset items."""
    from geneface_tpu_torch.inference import radnerf_infer

    inf = _infer(scene, torso)
    calls = []

    def counted(pose, *args, **kw):
        calls.append((pose, args[4:], kw))
        return frame_inputs(pose, *args, **kw)

    monkeypatch.setattr(radnerf_infer, "frame_inputs", counted)
    inf.prepare()
    ds = inf.dataset
    probes = range(0, len(ds), max(1, len(ds) // 4))[:4]
    assert len(calls) == 4 and all(np.array_equal(pose, ds.poses[i]) and not rest and not kw
                                   for (pose, rest, kw), i in zip(calls, probes))
    n = 0
    for i in probes:
        item = ds[i]
        hit = kdop_hit(torch.as_tensor(item["rays_o"]), torch.as_tensor(item["rays_d"]),
                       inf.cull_kdop, inf.render_kwargs["min_near"])
        n = max(n, int(hit.sum()))
    assert inf.ray_capacity == pick_ray_capacity(n, ds.H * ds.W) is not None
    if torso:
        mask = torso_occupancy_mask(inf.torso_occ, torch.as_tensor(ds.bg_coords),
                                    inf.render_kwargs["grid_size"],
                                    float(inf.cfg.get("density_thresh_torso", 0.01)))
        assert torch.equal(inf.torso_mask, mask) and bool(mask.any())


def test_cpu_frames_launch_no_kernel(head):
    before = dict(LAUNCHES)
    frames = head.render_frames(1)
    assert frames.shape == (1, HW, HW, 3)
    assert LAUNCHES == before and LAUNCHES["frame_inputs"] == before["frame_inputs"]


@pytest.mark.parametrize("bad", ["channels", "shape", "no_bg", "bg_shape", "bg_dtype", "empty"])
def test_wrapper_refuses_what_the_kernel_would(head, bad):
    ds = head.dataset
    plane = ds.samples[0]["torso_img"]
    bg = torch.as_tensor(ds.bg_img.reshape(-1, 3))
    H, W = ds.H, ds.W
    if bad == "channels":
        plane = np.zeros((H, W, 2), np.uint8)
    elif bad == "shape":
        plane = np.zeros((H, W + 1, 4), np.uint8)
    elif bad == "no_bg":
        bg = None
    elif bad == "bg_shape":
        bg = bg[:-1]
    elif bad == "bg_dtype":
        bg = bg.double()
    else:
        H = 0
    with pytest.raises(ValueError):
        frame_inputs(ds.poses[0], ds.intrinsics, H, W, "cpu", plane, bg)


def test_plain_rays_alone_skip_the_plane(head):
    ds = head.dataset
    o, d, bg = frame_inputs_plain(ds.poses[0], ds.intrinsics, ds.H, ds.W)
    assert bg is None and o.shape == d.shape == (ds.H * ds.W, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        frame_inputs(ds.poses[0], ds.intrinsics, ds.H, ds.W, "meta")


@pytest.mark.parametrize("bad", ["dtype", "strided", "unaligned", "bg_unaligned", "bg_device"])
def test_launcher_refuses_what_the_kernel_would(head, bad):
    """The launcher takes the plane already on its device: it refuses, before
    any build, a plane or background that the kernel would misread."""
    ds = head.dataset
    H, W = ds.H, ds.W
    plane = torch.as_tensor(ds.samples[0]["torso_img"])
    bg = torch.as_tensor(ds.bg_img.reshape(-1, 3))
    if bad == "dtype":
        plane = plane.to(torch.int16)
    elif bad == "strided":
        plane = torch.zeros(H, W, 8, dtype=torch.uint8)[..., :4]
    elif bad == "unaligned":  # uint8 RGBA one byte off its 4-byte pixel
        plane = torch.zeros(H * W * 4 + 1, dtype=torch.uint8)[1:].view(H, W, 4)
    elif bad == "bg_unaligned":
        bg = torch.zeros(H * W * 3 + 1)[1:].view(H * W, 3)
    else:
        bg = bg.to("meta")
    assert plane.shape == (H, W, 4)
    with pytest.raises(ValueError):
        launch_frame_inputs(ds.poses[0], ds.intrinsics, H, W, "cpu", plane, True, bg)
