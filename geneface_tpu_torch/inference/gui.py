"""Interactive real-time viewer (port of ``geneface_tpu/inference/gui.py``).

An :class:`OrbitCamera` (orbit, pan and zoom in the ngp convention), a
:class:`RealtimeRenderer` that renders the orbit camera's rays through
:meth:`RADNeRFInfer.render_rays` and holds a target frame time by stepping
along a fixed ladder of downscales (1, 0.75, 0.5, 0.25), and two frontends:

- :class:`NeRFGUI`, the dearpygui desktop app (only where ``dearpygui`` is
  installed; without it the constructor raises);
- :class:`NeRFWebGUI`, a viewer over plain ``http.server``: JPEG frames
  (``cv2``) and the control surface of the reference GUI's sliders as
  JSON state.

Run it on a trained work dir (the card unless ``--device cpu``)::

    python -m geneface_tpu_torch.inference.gui --config <yaml> \\
        --exp_name <dir> [--device cpu] [--port 8765]

The render knobs (``dt_gamma``, ``max_steps``, ``T_thresh``) go to the
renderer as arguments of each frame. The frame time that drives the ladder
runs until the frame is on the host, so it includes the device's work.
The torso's occupancy mask is sampled per frame at the rung's own screen
coordinates (the per-video mask of :meth:`RADNeRFInfer.prepare` fits only
the dataset's resolution).
"""

from __future__ import annotations

import argparse
import json
import math
import threading
import time

import numpy as np
import torch
from torch.profiler import record_function

from geneface_tpu_torch.data.radnerf_dataset import get_cond_window
from geneface_tpu_torch.utils.camera import get_rays

__all__ = ["OrbitCamera", "RealtimeRenderer", "NeRFGUI", "NeRFWebGUI", "decode_jpeg", "main"]


def _rotvec_to_matrix(rotvec: np.ndarray) -> np.ndarray:
    """Rodrigues' formula (replaces scipy's ``R.from_rotvec``)."""
    theta = float(np.linalg.norm(rotvec))
    if theta < 1e-12:
        return np.eye(3, dtype=np.float32)
    k = rotvec / theta
    K = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], np.float32
    )
    return np.eye(3, dtype=np.float32) + math.sin(theta) * K + (
        1 - math.cos(theta)
    ) * (K @ K)


class OrbitCamera:
    """Orbit camera in the ngp axis convention."""

    def __init__(self, W: int, H: int, r: float = 2.0, fovy: float = 60.0):
        self.W = W
        self.H = H
        self.radius = r
        self.fovy = fovy
        self.center = np.zeros(3, np.float32)
        self.rot = np.array(
            [[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float32
        )
        self.up = np.array([1, 0, 0], np.float32)

    @property
    def pose(self) -> np.ndarray:
        res = np.eye(4, dtype=np.float32)
        res[2, 3] -= self.radius
        rot = np.eye(4, dtype=np.float32)
        rot[:3, :3] = self.rot
        res = rot @ res
        res[:3, 3] -= self.center
        return res

    def update_pose(self, pose: np.ndarray) -> None:
        self.radius = float(np.linalg.norm(pose[:3, 3]))
        T = np.eye(4, dtype=np.float32)
        T[2, 3] = -self.radius
        rot = pose @ np.linalg.inv(T)
        self.rot = rot[:3, :3].astype(np.float32)

    def update_intrinsics(self, intrinsics) -> None:
        fl_x, fl_y, cx, cy = [float(v) for v in intrinsics]
        self.W = int(cx * 2)
        self.H = int(cy * 2)
        self.fovy = math.degrees(2 * math.atan2(self.H, 2 * fl_y))

    @property
    def intrinsics(self) -> np.ndarray:
        focal = self.H / (2 * math.tan(math.radians(self.fovy) / 2))
        return np.array([focal, focal, self.W // 2, self.H // 2], np.float32)

    def orbit(self, dx: float, dy: float) -> None:
        side = self.rot[:3, 0]
        rx = _rotvec_to_matrix(self.up * math.radians(-0.01 * dx))
        ry = _rotvec_to_matrix(side * math.radians(-0.01 * dy))
        self.rot = rx @ ry @ self.rot

    def scale(self, delta: float) -> None:
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx: float, dy: float, dz: float = 0.0) -> None:
        self.center += 1e-4 * (self.rot @ np.array([dx, dy, dz], np.float32))


_DOWNSCALE_LADDER = (1.0, 0.75, 0.5, 0.25)


class RealtimeRenderer:
    """Per-frame render loop with a frame-time-holding resolution ladder.
    Wraps a :class:`~geneface_tpu_torch.inference.radnerf_infer.RADNeRFInfer`;
    the constructor builds its per-video constants and, on the card, loads
    both kernels, so that no request pays for them."""

    def __init__(self, infer, target_frame_ms: float = 40.0,
                 dynamic_resolution: bool = True):
        self.infer = infer
        self.ds = infer.dataset
        self.target_frame_ms = target_frame_ms
        self.dynamic_resolution = dynamic_resolution
        self.downscale = 1.0
        #: fixes the downscale rung and turns the ladder off
        self.downscale_override: float | None = None
        self.cond_index = 0
        self.ind_index = 0
        #: render knobs; None → the config's value
        self.dt_gamma: float | None = None
        self.max_steps: int | None = None
        self.t_thresh: float | None = None
        #: solid background [r, g, b] in [0, 1]; None → the dataset's
        self.bg_color: list | None = None
        self.last_frame_ms = 0.0
        infer.prepare()
        if infer.device.type == "cuda":
            from geneface_tpu_torch.kernels import load_kernel

            load_kernel("scatter_add_rows")
            load_kernel("gather_rows")

    def _resolution(self):
        scale = self.downscale_override or self.downscale
        H = max(int(self.ds.H * scale) // 8 * 8, 8)
        W = max(int(self.ds.W * scale) // 8 * 8, 8)
        return H, W

    def ray_capacity(self, H: int, W: int) -> int | None:
        """The cull's capacity at an ``H × W`` rung: the video's capacity
        scaled by the pixel ratio, rounded up to 4,096; ``None`` (no cull)
        where it reaches every pixel."""
        cap = self.infer.ray_capacity
        if not cap:
            return None
        frac = (H * W) / float(self.ds.H * self.ds.W)
        cap = min(-(-int(cap * frac) // 4096) * 4096, H * W)
        return cap if cap < H * W else None

    def inputs(self, cam: OrbitCamera, cond_wins_all=None) -> dict:
        """The host inputs of the next frame at the current rung: the
        camera's rays, the background, the torso's screen coordinates, the
        condition window and the pose (numpy)."""
        with record_function("gf::inputs"):
            ds = self.ds
            H, W = self._resolution()
            fx, fy, cx, cy = [float(v) for v in cam.intrinsics]
            scale_h = H / cam.H
            scale_w = W / cam.W
            intr = (fx * scale_w, fy * scale_h, cx * scale_w, cy * scale_h)
            rays = get_rays(cam.pose, intr, H, W)
            conds = cond_wins_all if cond_wins_all is not None else ds.conds
            i = self.cond_index % len(conds)
            cond = get_cond_window(conds, i, self.infer.cfg.get("smo_win_size", 5))
            item = ds[i % len(ds)]
            if self.bg_color is not None:
                bg = np.broadcast_to(
                    np.asarray(self.bg_color, np.float32).reshape(1, 3), (H * W, 3)
                ).copy()
            else:
                bg_key = "bg_img" if self.infer.torso else "bg_torso_img"
                bg = np.asarray(item[bg_key]).reshape(ds.H, ds.W, 3)
                # nearest-resample the background to the render resolution
                yi = (np.arange(H) * ds.H // H)[:, None]
                xi = (np.arange(W) * ds.W // W)[None, :]
                bg = bg[yi, xi].reshape(-1, 3)
            # the JAX viewer's own coordinates: the column first (the dataset's
            # get_bg_coords puts the row first), kept as the oracle has them
            bg_coords = np.stack(
                [
                    (np.arange(H * W) % W) / max(W - 1, 1) * 2 - 1,
                    (np.arange(H * W) // W) / max(H - 1, 1) * 2 - 1,
                ],
                axis=-1,
            ).astype(np.float32)
            return {"H": H, "W": W, "rays_o": rays["rays_o"], "rays_d": rays["rays_d"], "bg": bg,
                    "bg_coords": bg_coords, "cond": cond, "pose": item["pose"],
                    "ray_capacity": self.ray_capacity(H, W)}

    @torch.inference_mode()
    def render(self, cam: OrbitCamera, cond_wins_all=None) -> np.ndarray:
        """→ uint8 frame [h, w, 3] at the current rung. Inference mode is
        set here: HTTP handler threads call this, and torch's grad mode is
        per thread."""
        infer = self.infer
        x = self.inputs(cam, cond_wins_all)
        H, W = x["H"], x["W"]
        dev = infer.device
        t0 = time.perf_counter()
        out = infer.render_rays(
            *(torch.as_tensor(x[k], device=dev) for k in ("rays_o", "rays_d", "bg")),
            torch.as_tensor(x["bg_coords"], device=dev) if infer.torso else None,
            x["cond"], torch.as_tensor(x["pose"], device=dev), int(self.ind_index),
            ray_capacity=x["ray_capacity"], cull_kdop=infer.cull_kdop, torso_mask=None,
            dt_gamma=self.dt_gamma, max_steps=self.max_steps, T_thresh=self.t_thresh,
        )
        # on the host: the clock stops after the device's work
        frame = out["rgb_map"].float().cpu().numpy().reshape(H, W, 3)
        dt_ms = (time.perf_counter() - t0) * 1e3
        self.last_frame_ms = dt_ms

        if self.dynamic_resolution and self.downscale_override is None:
            # the rung whose full-resolution-equivalent time meets the target
            full_t = dt_ms / (self.downscale**2)
            want = min(1.0, max(0.25, math.sqrt(self.target_frame_ms / full_t)))
            for rung in _DOWNSCALE_LADDER:
                if rung <= want * 1.2:
                    break
            if rung != self.downscale:
                self.downscale = rung
        return (np.clip(frame, 0, 1) * 255).astype(np.uint8)


class NeRFGUI:
    """dearpygui desktop frontend. Available only where dearpygui is
    installed; without it the constructor raises — use :class:`NeRFWebGUI`."""

    def __init__(self, infer, W: int = 512, H: int = 512):
        try:
            import dearpygui.dearpygui as dpg  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "dearpygui is not installed; use NeRFWebGUI for the "
                "browser-based viewer"
            ) from e
        self.dpg = dpg
        self.renderer = RealtimeRenderer(infer)
        self.cam = OrbitCamera(W, H)
        self.cam.update_intrinsics(infer.dataset.intrinsics)

    def render(self):  # pragma: no cover - needs a display
        dpg = self.dpg
        dpg.create_context()
        W, H = self.cam.W, self.cam.H
        frame = self.renderer.render(self.cam).astype(np.float32) / 255.0
        with dpg.texture_registry():
            dpg.add_raw_texture(
                W, H, frame.ravel(), format=dpg.mvFormat_Float_rgb,
                tag="_texture",
            )
        rend = self.renderer
        with dpg.window(tag="_primary"):
            dpg.add_image("_texture")
            dpg.add_slider_int(
                label="Audio", min_value=0,
                max_value=max(len(rend.ds.conds) - 1, 0),
                callback=lambda s, a: setattr(rend, "cond_index", a),
            )
            dpg.add_slider_int(
                label="Individual", min_value=0, max_value=1 << 12,
                callback=lambda s, a: setattr(rend, "ind_index", a),
            )
            dpg.add_slider_int(
                label="FoV (vertical)", min_value=1, max_value=120,
                default_value=int(self.cam.fovy),
                callback=lambda s, a: setattr(self.cam, "fovy", a),
            )
            dpg.add_slider_float(
                label="dt_gamma", min_value=0.0, max_value=0.1,
                format="%.5f",
                callback=lambda s, a: setattr(rend, "dt_gamma", a),
            )
            dpg.add_slider_int(
                label="max steps", min_value=1, max_value=64,
                default_value=16,
                callback=lambda s, a: setattr(rend, "max_steps", a),
            )
            dpg.add_slider_float(
                label="T_thresh", min_value=1e-5, max_value=1e-1,
                format="%.5f",
                callback=lambda s, a: setattr(rend, "t_thresh", a),
            )
            dpg.add_color_edit(
                (255, 255, 255), label="Background Color", no_alpha=True,
                callback=lambda s, a: setattr(
                    rend, "bg_color", [float(c) for c in a[:3]]
                ),
            )
        with dpg.handler_registry():
            dpg.add_mouse_drag_handler(
                callback=lambda s, a: (
                    self.cam.orbit(a[1], a[2]),
                )
            )
            dpg.add_mouse_wheel_handler(
                callback=lambda s, a: self.cam.scale(a)
            )
        dpg.create_viewport(title="geneface-tpu", width=W, height=H)
        dpg.setup_dearpygui()
        dpg.show_viewport()
        dpg.set_primary_window("_primary", True)
        while dpg.is_dearpygui_running():
            frame = self.renderer.render(self.cam).astype(np.float32) / 255.0
            dpg.set_value("_texture", frame.ravel())
            self.renderer.cond_index += 1
            dpg.render_dearpygui_frame()
        dpg.destroy_context()


_PAGE = """<!doctype html><html><head><title>geneface-tpu viewer</title>
<style>body{margin:0;background:#111;color:#eee;font:13px monospace;
display:flex}#hud{position:fixed;top:8px;left:8px}
#panel{padding:10px;min-width:260px}#panel label{display:block;margin:6px 0}
#panel input{width:120px;vertical-align:middle}</style></head>
<body><div><img id="v" draggable="false"><div id="hud"></div></div>
<div id="panel">
<label>audio <input type=range id=cond_index min=0 max=0 step=1>
  <span id=cond_index_v></span></label>
<label>ind code <input type=number id=ind_index min=0 value=0></label>
<label>FoV <input type=range id=fovy min=1 max=120 step=1>
  <span id=fovy_v></span></label>
<label>dt_gamma <input type=number id=dt_gamma step=0.001 placeholder=cfg></label>
<label>max steps <input type=number id=max_steps min=1 max=64 placeholder=cfg></label>
<label>T_thresh <input type=number id=t_thresh step=0.0001 placeholder=cfg></label>
<label>downscale <select id=downscale><option value=0>auto</option>
  <option value=1>1.0</option><option value=0.75>0.75</option>
  <option value=0.5>0.5</option><option value=0.25>0.25</option></select></label>
<label>target ms <input type=number id=target_frame_ms min=1 value=40></label>
</div><script>
let playing = true;
const KEYS = ['cond_index','ind_index','fovy','dt_gamma','max_steps',
              't_thresh','downscale','target_frame_ms'];
async function loadState(){
  const s = await (await fetch('/state')).json();
  document.getElementById('cond_index').max = s.n_conds - 1;
  for (const k of KEYS){ const el = document.getElementById(k);
    if (s[k] !== null && s[k] !== undefined) el.value = s[k]; }
}
for (const k of KEYS){
  document.getElementById(k).onchange = e => {
    const v = e.target.value;
    fetch('/state', {method:'POST',
      body: JSON.stringify({[k]: v === '' ? null : parseFloat(v)})});
  };
}
async function tick(){
  const img = document.getElementById('v');
  const r = await fetch('/frame' + (playing ? '?advance=1' : ''));
  const meta = JSON.parse(r.headers.get('x-meta'));
  img.src = URL.createObjectURL(await r.blob());
  document.getElementById('hud').textContent =
    `frame ${meta.cond_index}  ${meta.w}x${meta.h}  ${meta.ms.toFixed(1)} ms`;
  document.getElementById('cond_index').value = meta.cond_index;
  setTimeout(tick, 10);
}
let drag = null;
v.onmousedown = e => drag = [e.clientX, e.clientY];
window.onmouseup = () => drag = null;
window.onmousemove = e => { if (drag) {
  fetch(`/orbit?dx=${e.clientX-drag[0]}&dy=${e.clientY-drag[1]}`);
  drag = [e.clientX, e.clientY]; } };
window.onwheel = e => fetch(`/zoom?d=${e.deltaY>0?-1:1}`);
window.onkeydown = e => { if (e.key===' ') playing = !playing; };
loadState(); tick();
</script></body></html>"""


def decode_jpeg(body: bytes) -> np.ndarray | None:
    """A ``/frame`` body → the RGB frame ``[h, w, 3]`` uint8 (``None`` if
    it does not decode): the inverse of the viewer's encoding, for Python
    clients of the server."""
    import cv2

    img = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class NeRFWebGUI:
    """Browser viewer over plain ``http.server``.

    Endpoints: ``/`` (page), ``/frame[?advance=1]`` (JPEG + x-meta header),
    ``/orbit?dx&dy``, ``/zoom?d``, ``/state`` (GET, and POST to set).
    """

    def __init__(self, infer, host: str = "127.0.0.1", port: int = 8765):
        self.renderer = RealtimeRenderer(infer)
        self.cam = OrbitCamera(infer.dataset.W, infer.dataset.H)
        self.cam.update_intrinsics(infer.dataset.intrinsics)
        self.cam.update_pose(np.asarray(infer.dataset.poses[0]))
        self.host = host
        self.port = port
        self._lock = threading.Lock()

    def _encode_jpeg(self, frame: np.ndarray) -> bytes:
        import cv2

        ok, buf = cv2.imencode(
            ".jpg", cv2.cvtColor(frame, cv2.COLOR_RGB2BGR),
            [int(cv2.IMWRITE_JPEG_QUALITY), 90],
        )
        if not ok:
            raise RuntimeError("cv2.imencode failed to encode the frame")
        return bytes(buf)

    def make_handler(self):
        gui = self

        from http.server import BaseHTTPRequestHandler
        from urllib.parse import parse_qs, urlparse

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body, ctype="text/html", extra=None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)
                if u.path == "/":
                    self._send(200, _PAGE.encode())
                elif u.path == "/frame":
                    with gui._lock:
                        if q.get("advance"):
                            gui.renderer.cond_index += 1
                        frame = gui.renderer.render(gui.cam)
                    meta = json.dumps(
                        {
                            "cond_index": gui.renderer.cond_index,
                            "h": frame.shape[0],
                            "w": frame.shape[1],
                            "ms": gui.renderer.last_frame_ms,
                        }
                    )
                    self._send(
                        200, gui._encode_jpeg(frame), "image/jpeg",
                        {"x-meta": meta},
                    )
                elif u.path == "/orbit":
                    with gui._lock:
                        gui.cam.orbit(
                            float(q.get("dx", [0])[0]), float(q.get("dy", [0])[0])
                        )
                    self._send(200, b"ok", "text/plain")
                elif u.path == "/zoom":
                    with gui._lock:
                        gui.cam.scale(float(q.get("d", [0])[0]))
                    self._send(200, b"ok", "text/plain")
                elif u.path == "/state":
                    self._send(
                        200, json.dumps(gui.state()).encode(),
                        "application/json",
                    )
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                u = urlparse(self.path)
                if u.path != "/state":
                    self._send(404, b"not found", "text/plain")
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    self._send(400, b"bad json", "text/plain")
                    return
                with gui._lock:
                    gui.apply_state(payload)
                self._send(
                    200, json.dumps(gui.state()).encode(), "application/json"
                )

        return Handler

    # ------------------------------------------------- control surface ----
    #: every slider of the reference GUI has a state key: audio scrub
    #: (cond_index), individual code (ind_index), FoV (fovy), dt_gamma,
    #: max_steps, T_thresh (t_thresh), manual downscale (downscale_override,
    #: 0/None → the ladder), background colour, target frame time.
    def state(self) -> dict:
        r = self.renderer
        return {
            "radius": float(self.cam.radius),
            "fovy": float(self.cam.fovy),
            "downscale": float(r.downscale_override or r.downscale),
            "downscale_override": r.downscale_override,
            "dynamic_resolution": bool(r.dynamic_resolution),
            "cond_index": int(r.cond_index),
            "n_conds": int(len(self.renderer.ds.conds)),
            "ind_index": int(r.ind_index),
            "dt_gamma": r.dt_gamma,
            "max_steps": r.max_steps,
            "t_thresh": r.t_thresh,
            "bg_color": r.bg_color,
            "target_frame_ms": float(r.target_frame_ms),
            "last_frame_ms": float(r.last_frame_ms),
        }

    def apply_state(self, payload: dict) -> None:
        r = self.renderer
        if "fovy" in payload:
            self.cam.fovy = float(np.clip(float(payload["fovy"]), 1.0, 120.0))
        if "radius" in payload:
            self.cam.radius = max(float(payload["radius"]), 1e-3)
        if "cond_index" in payload:
            r.cond_index = int(payload["cond_index"])
        if "ind_index" in payload:
            r.ind_index = max(int(payload["ind_index"]), 0)
        if "dt_gamma" in payload:
            v = payload["dt_gamma"]
            r.dt_gamma = None if v in (None, "") else float(v)
        if "max_steps" in payload:
            v = payload["max_steps"]
            r.max_steps = None if v in (None, "") else max(int(v), 1)
        if "t_thresh" in payload:
            v = payload["t_thresh"]
            r.t_thresh = None if v in (None, "") else float(v)
        if "bg_color" in payload:
            v = payload["bg_color"]
            r.bg_color = None if v in (None, "") else [
                float(np.clip(c, 0.0, 1.0)) for c in v
            ][:3]
        if "downscale" in payload:
            v = float(payload["downscale"] or 0)
            r.downscale_override = None if v <= 0 else min(
                _DOWNSCALE_LADDER, key=lambda x: abs(x - v)
            )
        if "target_frame_ms" in payload:
            r.target_frame_ms = max(float(payload["target_frame_ms"]), 1.0)

    def serve(self, blocking: bool = True):
        from http.server import ThreadingHTTPServer

        self.httpd = ThreadingHTTPServer(
            (self.host, self.port), self.make_handler()
        )
        print(f"NeRFWebGUI serving on http://{self.host}:{self.httpd.server_address[1]}")
        if blocking:  # pragma: no cover
            self.httpd.serve_forever()
        else:
            self._thread = threading.Thread(
                target=self.httpd.serve_forever, daemon=True
            )
            self._thread.start()
        return self.httpd

    def close(self):
        if hasattr(self, "httpd"):
            self.httpd.shutdown()
            self.httpd.server_close()


def main(argv: list | None = None) -> int:  # pragma: no cover - serves until killed
    """Serve a RAD-NeRF work dir (head, or head+torso) in the browser."""
    from geneface_tpu_torch.config.config import load_config
    from geneface_tpu_torch.inference.radnerf_infer import RADNeRFInfer

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--exp_name", default="")
    ap.add_argument("--hparams", default="")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8765)
    args = ap.parse_args(argv)
    work_dir = f"checkpoints/{args.exp_name}" if args.exp_name else None
    cfg = load_config(args.config, overrides=args.hparams, work_dir=work_dir)
    gui = NeRFWebGUI(RADNeRFInfer(cfg, device=args.device), args.host, args.port)
    gui.serve(blocking=True)
    return 0


if __name__ == "__main__":
    main()
