"""The real-time viewer: the port's ``OrbitCamera``, ``RealtimeRenderer`` and
``NeRFWebGUI`` on the CPU against the JAX package's, on one JAX-written
head checkpoint and one torso checkpoint that both sides read.

Tolerances: the camera's pose, orbit, pan, zoom and intrinsics are
float32 numpy on both sides, copied: equal to 1e-6. The viewer's frames
at float32 MLPs, at rungs 1.0 and 0.5 with knob overrides and individual
code 1: the float frame within 1e-5 absolute per pixel (the same samples;
sums run in another order and the torso adds its MLP and grid), the uint8
frame within one level. Both sides build the same rays (the numpy
``get_rays``), held equal first.
"""

import json
import os
import sys
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneface_tpu.config import Config as JConfig
from geneface_tpu.inference import gui as jgui
from geneface_tpu.inference.radnerf_infer import RADNeRFInfer as JInfer
from geneface_tpu.models.radnerf import RADNeRF as JRADNeRF
from geneface_tpu.models.radnerf import RADNeRFTorso as JTorso
from geneface_tpu.models.radnerf.renderer import OccupancyState as JOcc
from geneface_tpu.models.radnerf.renderer import TorsoOccupancyState as JTorsoOcc
from geneface_tpu.tasks.radnerf import model_from_cfg as jmodel_from_cfg
from geneface_tpu.utils.camera import get_rays as jget_rays
from geneface_tpu.utils.checkpoint import save_checkpoint as jsave
from geneface_tpu_torch.inference import (
    NeRFGUI,
    NeRFWebGUI,
    OrbitCamera,
    RADNeRFInfer,
    RealtimeRenderer,
)
from geneface_tpu_torch.kernels import LAUNCHES

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.make_synthetic_dataset import make_dataset  # noqa: E402

torch.set_num_threads(1)

HW = 96  # the smallest scene whose cull engages (capacities are multiples of 4,096 rays)


def _cfg(data_dir, work_dir):
    return dict(
        data_dir=data_dir, work_dir=work_dir,
        cond_type="idexp_lm3d_normalized", cond_win_size=1, smo_win_size=3,
        cond_out_dim=16, with_att=True, bound=1, grid_type="tiledgrid",
        log2_hashmap_size=14, desired_resolution=128, grid_size=32,
        num_layers_ambient=2, hidden_dim_ambient=16, num_layers_sigma=2,
        hidden_dim_sigma=16, geo_feat_dim=16, num_layers_color=2,
        hidden_dim_color=16, individual_embedding_num=16,
        individual_embedding_dim=4, max_steps=8, min_near=0.05,
        mean_samples_per_ray=8, seed=0, torso_head_aware=True,
    )


def _jax_model(cfg, torso):
    kw = dict(torso_head_aware=True) if torso else {}
    return jmodel_from_cfg(JConfig(cfg), JTorso if torso else JRADNeRF, dtype=jnp.float32, **kw)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A head and a torso checkpoint (JAX-initialised, an occupancy ball, a
    torso grid planted over half the screen), written by the JAX package."""
    root = tmp_path_factory.mktemp("torch_gui")
    data = str(root / "data")
    make_dataset(data, n_frames=4, hw=HW)
    cfgs = {}
    for kind in ("head", "torso"):
        cfg = _cfg(data, str(root / kind))
        jmodel = _jax_model(cfg, kind == "torso")
        params = jax.jit(lambda key, m=jmodel: m.init(
            key, jnp.zeros((3, 1, 204)), jnp.zeros((8, 3)), jnp.zeros((8, 3)),
            method=m.init_all))(jax.random.PRNGKey(0))
        params = jax.tree_util.tree_map(np.array, params)
        params["params"]["sigma_net"]["Dense_1"]["kernel"][:, 0] += 0.5
        H = cfg["grid_size"]
        r = (np.arange(H) + 0.5) / H * 2.0 - 1.0
        gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
        occ = np.sqrt(gx**2 + gy**2 + gz**2) < 0.5
        dens = np.where(occ, 40.0, 0.0).reshape(1, -1).astype(np.float32)
        state = {"params": params,
                 "occ": JOcc(jnp.asarray(dens), jnp.asarray(occ[None]), jnp.asarray(0.0))}
        if kind == "torso":
            params["params"]["torso_canonical_net"]["Dense_2"]["kernel"][:, 0] += 1.0
            g = np.zeros((H, H), np.float32)
            g[:, H // 2 + 1:] = 0.5
            state["torso_occ"] = JTorsoOcc(jnp.asarray(g.reshape(-1)), jnp.asarray(g.mean()))
        jsave(os.path.join(cfg["work_dir"], "model_ckpt_steps_0.ckpt"),
              {"state": state, "step": 0})
        cfgs[kind] = cfg
    return cfgs


@pytest.fixture(scope="module")
def head_infer(scene):
    return RADNeRFInfer(scene["head"], device="cpu", dtype=torch.float32)


def _camera(cls, ds):
    cam = cls(ds.W, ds.H)
    cam.update_intrinsics(ds.intrinsics)
    cam.update_pose(np.asarray(ds.poses[0]))
    cam.orbit(40.0, -15.0)  # an orbit pose, not a dataset one
    return cam


def test_orbit_camera_matches_jax():
    cams = [cls(64, 48, r=2.0, fovy=50.0) for cls in (OrbitCamera, jgui.OrbitCamera)]
    pose = np.asarray(jgui.OrbitCamera(64, 48).pose)
    pose[:3, 3] += [0.1, -0.2, 0.3]
    for step in (lambda c: c.orbit(100.0, 50.0), lambda c: c.scale(1.5),
                 lambda c: c.pan(30.0, -20.0, 5.0), lambda c: c.update_pose(pose),
                 lambda c: c.orbit(-12.0, 7.0),
                 lambda c: c.update_intrinsics((70.0, 72.0, 40.0, 30.0))):
        for c in cams:
            step(c)
        a, b = cams
        np.testing.assert_allclose(a.pose, b.pose, rtol=0, atol=1e-6)
        np.testing.assert_allclose(a.intrinsics, b.intrinsics, rtol=0, atol=1e-6)
        assert (a.W, a.H) == (b.W, b.H) and abs(a.fovy - b.fovy) < 1e-9
        assert abs(a.radius - b.radius) < 1e-6
    RtR = cams[0].pose[:3, :3].T @ cams[0].pose[:3, :3]
    np.testing.assert_allclose(RtR, np.eye(3), atol=1e-5)


def _capture_jax(jr):
    """Wrap the JAX viewer's jitted frame function: keep its arguments and
    its float frame."""
    real = jr._render_fn

    def fn():
        f = real()

        def call(*args, **kw):
            out = f(*args, **kw)
            jr.captured = {"args": args, "kw": kw, "rgb": np.asarray(out)}
            return out

        return call

    jr._render_fn = fn


@pytest.mark.parametrize("kind", ["head", "torso"])
def test_realtime_renderer_matches_jax(scene, kind):
    cfg = scene[kind]
    jinf = JInfer(JConfig(cfg))
    assert jinf.torso == (kind == "torso")
    jinf.model = _jax_model(cfg, jinf.torso)  # the JAX viewer's MLPs at float32 too
    inf = RADNeRFInfer(cfg, device="cpu", dtype=torch.float32)
    rend = RealtimeRenderer(inf, target_frame_ms=1e9)
    jr = jgui.RealtimeRenderer(jinf, target_frame_ms=1e9)
    _capture_jax(jr)
    ds = inf.dataset
    cam, jcam = _camera(OrbitCamera, ds), _camera(jgui.OrbitCamera, jinf.dataset)
    knobs = {1.0: {}, 0.5: dict(dt_gamma=0.01, max_steps=6, t_thresh=1e-3)}
    for cond_index, (rung, kn) in enumerate(knobs.items(), start=1):
        for r in (rend, jr):
            r.downscale_override = rung
            r.cond_index, r.ind_index = cond_index, 1
            r.dt_gamma, r.max_steps, r.t_thresh = (kn.get(k) for k in
                                                   ("dt_gamma", "max_steps", "t_thresh"))
        x = rend.inputs(cam)
        H, W = x["H"], x["W"]
        assert H == max(int(HW * rung) // 8 * 8, 8)
        # the same rays on both sides
        fx, fy, cx, cy = [float(v) for v in jcam.intrinsics]
        jrays = jget_rays(jcam.pose, (fx * W / jcam.W, fy * H / jcam.H, cx * W / jcam.W,
                                      cy * H / jcam.H), H, W)
        for k in ("rays_o", "rays_d"):
            np.testing.assert_array_equal(x[k], jrays[k])
        before = dict(LAUNCHES)
        got = rend.render(cam)
        assert LAUNCHES == before  # the CPU runs the plain versions
        want = jr.render(jcam)
        assert got.shape == want.shape == (H, W, 3) and got.dtype == np.uint8
        rgb = inf.last_render["rgb_map"].numpy()
        args = jr.captured["args"]
        # the viewer's inputs are the JAX viewer's: background, screen
        # coordinates, condition window, pose, capacity
        for name, i in (("bg", 4), ("bg_coords", 5), ("cond", 6), ("pose", 7)):
            np.testing.assert_array_equal(x[name], np.asarray(args[i]), err_msg=name)
        assert x["ray_capacity"] == jr.captured["kw"]["ray_capacity"]
        assert (x["ray_capacity"] is not None) == (rung == 1.0)  # the cull engages at 96²
        # the quirk: the viewer's first coordinate is the column, the
        # dataset's (get_bg_coords) the row — transposed at rung 1.0
        if rung == 1.0:
            for coords in (x["bg_coords"], np.asarray(args[5])):
                np.testing.assert_allclose(coords, ds.bg_coords[:, ::-1], atol=1e-6)
                assert np.abs(coords - ds.bg_coords).max() > 1.0
        err = np.abs(rgb - jr.captured["rgb"])
        assert err.max() <= 1e-5, (kind, rung, err.max())
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        assert np.abs(rgb - x["bg"]).max() > 0.05  # the head shows
        # the individual code is the second one, as on the JAX side
        assert not np.array_equal(inf.model.individual_embeddings[1].detach().numpy(),
                                  inf.model.individual_embeddings[0].detach().numpy())


def test_render_frame_is_render_rays(head_infer):
    """``render_frame`` is ``render_rays`` on the dataset's rays and code 0."""
    inf = head_infer
    inf.prepare()
    ds = inf.dataset
    item = ds[1]
    a = inf.render_frame(1)["rgb_map"]
    from geneface_tpu_torch.data.radnerf_dataset import get_cond_window

    b = inf.render_rays(torch.as_tensor(item["rays_o"]), torch.as_tensor(item["rays_d"]),
                        torch.as_tensor(item["bg_torso_img"]), None,
                        get_cond_window(ds.conds, 1, 3), torch.as_tensor(item["pose"]), 0,
                        ray_capacity=inf.ray_capacity, cull_kdop=inf.cull_kdop)["rgb_map"]
    assert torch.equal(a, b)
    c = inf.render_rays(torch.as_tensor(item["rays_o"]), torch.as_tensor(item["rays_d"]),
                        torch.as_tensor(item["bg_torso_img"]), None,
                        get_cond_window(ds.conds, 1, 3), torch.as_tensor(item["pose"]), 16,
                        ray_capacity=inf.ray_capacity, cull_kdop=inf.cull_kdop)["rgb_map"]
    assert torch.equal(a, c)  # 16 % 16 codes: the first code again


def test_ladder_steps_down(head_infer):
    r = RealtimeRenderer(head_infer, target_frame_ms=1e-6)  # impossible
    cam = _camera(OrbitCamera, head_infer.dataset)
    r.render(cam)
    assert r.downscale < 1.0 and r.last_frame_ms > 0
    assert r.render(cam).shape[0] < HW
    r.target_frame_ms = 1e9  # generous: back up to full resolution
    r.render(cam)
    assert r.downscale == 1.0


def test_desktop_gui_needs_dearpygui(head_infer):
    try:
        import dearpygui  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="dearpygui"):
            NeRFGUI(head_infer)


def test_web_gui_roundtrip_and_controls(head_infer):
    import cv2

    gui = NeRFWebGUI(head_infer, port=0)
    httpd = gui.serve(blocking=False)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(payload):
        req = urllib.request.Request(f"{base}/state", data=json.dumps(payload).encode(),
                                     method="POST")
        return json.loads(urllib.request.urlopen(req).read())

    def get_state():
        return json.loads(urllib.request.urlopen(f"{base}/state").read())

    try:
        assert b"geneface-tpu" in urllib.request.urlopen(f"{base}/").read()
        resp = urllib.request.urlopen(f"{base}/frame?advance=1")
        meta = json.loads(resp.headers["x-meta"])
        assert resp.read()[:2] == b"\xff\xd8"  # JPEG
        assert meta["cond_index"] == 1 and meta["ms"] > 0 and meta["h"] == HW
        assert urllib.request.urlopen(f"{base}/orbit?dx=20&dy=5").read() == b"ok"
        assert urllib.request.urlopen(f"{base}/zoom?d=1").read() == b"ok"
        st = get_state()
        assert st["radius"] > 0 and st["cond_index"] == 1
        for key in ("cond_index", "n_conds", "ind_index", "fovy", "dt_gamma", "max_steps",
                    "t_thresh", "downscale", "bg_color", "target_frame_ms", "radius",
                    "dynamic_resolution"):
            assert key in st, key
        st = post({"cond_index": 3, "ind_index": 2, "fovy": 45.0, "dt_gamma": 0.01,
                   "max_steps": 4, "t_thresh": 1e-3, "bg_color": [1.0, 0.0, 0.0],
                   "downscale": 0.5, "target_frame_ms": 25.0})
        assert st["cond_index"] == 3 and st["ind_index"] == 2
        assert abs(st["fovy"] - 45.0) < 1e-6 and abs(st["dt_gamma"] - 0.01) < 1e-9
        assert st["max_steps"] == 4 and abs(st["t_thresh"] - 1e-3) < 1e-9
        assert st["bg_color"] == [1.0, 0.0, 0.0] and st["downscale"] == 0.5
        assert abs(st["target_frame_ms"] - 25.0) < 1e-6
        # the knobs reach the render: the 0.5 rung and the red background
        resp = urllib.request.urlopen(f"{base}/frame")
        meta = json.loads(resp.headers["x-meta"])
        assert meta["h"] == max(int(HW * 0.5) // 8 * 8, 8)
        frame = cv2.imdecode(np.frombuffer(resp.read(), np.uint8), cv2.IMREAD_COLOR)
        assert frame.shape[:2] == (meta["h"], meta["w"])
        assert frame[0][:, 2].mean() > 150 and frame[0][:, 0].mean() < 80  # BGR: red
        post({"dt_gamma": None, "max_steps": None, "t_thresh": None, "downscale": 0,
              "bg_color": None})
        st = get_state()
        assert st["dt_gamma"] is None and st["max_steps"] is None
        assert st["t_thresh"] is None and st["bg_color"] is None
        assert st["downscale_override"] is None
        urllib.request.urlopen(f"{base}/frame").read()
        req = urllib.request.Request(f"{base}/state", data=b"{not json", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nothing")
        assert e.value.code == 404
        assert get_state()["radius"] > 0
    finally:
        gui.close()
