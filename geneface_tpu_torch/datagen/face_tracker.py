"""3DMM head-pose tracker: fit (id, exp, euler, trans, focal) to 2-D
landmarks, then refine photometrically (port of
``geneface_tpu/datagen/face_tracker.py``).

The JAX package runs each fit as one jitted ``lax.scan`` of ``optax.adam``
and ``vmap``s the focal search. Here a fit is a Python loop of autograd
steps and Adam with optax's arithmetic (:func:`_adam_update`); the focal
search is one fit with a leading candidate axis, each candidate's loss its
own mean, so that the summed loss gives each candidate its own gradient
and the elementwise Adam makes the batched fit exact. As in the JAX
package, a fit reports the loss of its last step at the parameters before
that step's update, and the focal is the argmin of those losses.

The photometric objective renders with
:mod:`geneface_tpu_torch.datagen.face_renderer` (the normals and the splat
on the row scatter-add K1, their backward on the row gather K8). In the
per-frame stage ``id`` and ``tex`` are frozen: they neither move nor keep
Adam moments (``optax.multi_transform`` with ``set_to_zero``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.profiler

__all__ = [
    "FaceBasis",
    "basis_from_bfm",
    "project_landmarks",
    "fit_sequence",
    "refine_photometric",
]


class FaceBasis(NamedTuple):
    """Landmark-restricted 3DMM: lm3d = mean + id_base @ id + exp_base @ exp."""

    mean: torch.Tensor  # [68*3]
    id_base: torch.Tensor  # [68*3, id_dim]
    exp_base: torch.Tensor  # [68*3, exp_dim]

    def to(self, device) -> "FaceBasis":
        return FaceBasis(*(t.to(device) for t in self))


def basis_from_bfm(mat_path: str, device="cpu") -> FaceBasis:
    """A landmark basis from BFM09's ``BFM_model_front.mat`` (not in the
    repository)."""
    from scipy.io import loadmat

    m = loadmat(mat_path)
    kp = (m["keypoints"].reshape(-1) - 1).astype(np.int64)  # 1-based -> 0
    sel = np.stack([3 * kp, 3 * kp + 1, 3 * kp + 2], -1).reshape(-1)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return FaceBasis(mean=f32(m["meanshape"].reshape(-1)[sel]),
                     id_base=f32(m["idBase"][sel]), exp_base=f32(m["exBase"][sel]))


def _euler_to_rot(euler: torch.Tensor) -> torch.Tensor:
    """[..., 3] (pitch, yaw, roll) → [..., 3, 3] rotation, ``Rx @ Ry @ Rz``."""
    x, y, z = euler[..., 0], euler[..., 1], euler[..., 2]
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    rx = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx], -1).reshape(*x.shape, 3, 3)
    ry = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy], -1).reshape(*x.shape, 3, 3)
    rz = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one], -1).reshape(*x.shape, 3, 3)
    return rx @ ry @ rz


def _cam_geometry(basis, id_para, exp_para, euler, trans) -> torch.Tensor:
    """Camera-space geometry ``[..., T, N, 3]`` of a :class:`FaceBasis` or a
    ``FullFaceBasis``; ``id_para [..., id]``, ``exp_para [..., T, exp]``."""
    geo = (
        basis.mean
        + (id_para @ basis.id_base.T)[..., None, :]
        + exp_para @ basis.exp_base.T
    )
    geo = geo.reshape(*geo.shape[:-1], -1, 3)
    rot = _euler_to_rot(euler)  # [..., T, 3, 3]
    return geo @ rot.transpose(-1, -2) + trans[..., None, :]


def _project(cam: torch.Tensor, focal, cxy) -> torch.Tensor:
    z = torch.maximum(cam[..., 2], cam.new_tensor(1e-5))
    u = focal * cam[..., 0] / z + cxy[0]
    v = focal * cam[..., 1] / z + cxy[1]
    return torch.stack([u, v], -1)


def project_landmarks(
    basis: FaceBasis,
    id_para: torch.Tensor,  # [..., id_dim] (shared across frames)
    exp_para: torch.Tensor,  # [..., T, exp_dim]
    euler: torch.Tensor,  # [..., T, 3]
    trans: torch.Tensor,  # [..., T, 3]
    focal,  # scalar, or [...] with one focal per leading index
    cxy: torch.Tensor,  # [2]
) -> torch.Tensor:
    """→ projected 2-D landmarks [..., T, 68, 2] (pinhole, +z forward)."""
    focal = torch.as_tensor(focal, dtype=exp_para.dtype, device=exp_para.device)
    cam = _cam_geometry(basis, id_para, exp_para, euler, trans)
    return _project(cam, focal[..., None, None], cxy)


def _landmark_loss(params, basis, lms, focal, cxy, reg_id, reg_exp) -> torch.Tensor:
    """Loss of each leading index ``[...]``: mean squared landmark distance
    plus the id and exp regularizers."""
    pred = project_landmarks(basis, params["id"], params["exp"], params["euler"],
                             params["trans"], focal, cxy)
    loss = ((pred - lms) ** 2).sum(-1).mean((-2, -1))
    reg = reg_id * (params["id"] ** 2).sum(-1) + reg_exp * (params["exp"] ** 2).sum((-2, -1))
    return loss + reg


def _adam_update(params: dict, grads: dict, state: dict, lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """One step of ``optax.adam(lr)`` in place, in optax's order of
    operations; ``state`` holds ``count`` and each key's ``mu``/``nu``."""
    state["count"] += 1
    c1 = 1 - b1 ** state["count"]
    c2 = 1 - b2 ** state["count"]
    with torch.no_grad():
        for k, g in grads.items():
            mu = state["mu"][k].mul_(b1).add_((1 - b1) * g)
            nu = state["nu"][k].mul_(b2).add_((1 - b2) * (g * g))
            params[k].add_(-lr * ((mu / c1) / (torch.sqrt(nu / c2) + eps)))


def _adam_loop(loss_fn, params: dict, trained: tuple, steps: int, lr: float):
    """``steps`` Adam steps on the keys ``trained`` of ``params`` (the rest
    held fixed, without moments) → (params, what ``loss_fn`` returned at the
    last step, before its update). ``loss_fn(params)`` → (scalar to
    differentiate, anything to report)."""
    params = {k: v.detach().clone().requires_grad_(k in trained) for k, v in params.items()}
    state = {"count": 0, "mu": {k: torch.zeros_like(params[k]) for k in trained},
             "nu": {k: torch.zeros_like(params[k]) for k in trained}}
    last = None
    for _ in range(steps):
        total, last = loss_fn(params)
        grads = torch.autograd.grad(total, [params[k] for k in trained])
        _adam_update(params, dict(zip(trained, grads)), state, lr)
    return {k: v.detach() for k, v in params.items()}, last


def _fit_once(basis, lms, focal, cxy, init, steps: int, lr: float,
              reg_id: float = 1e-4, reg_exp: float = 1e-4):
    """Landmark fit of every leading index of ``init`` at once (one focal
    each) → (params, loss of each index at the last step before its
    update)."""

    def loss_fn(p):
        losses = _landmark_loss(p, basis, lms, focal, cxy, reg_id, reg_exp)
        return losses.sum(), losses.detach()

    return _adam_loop(loss_fn, init, ("id", "exp", "euler", "trans"), steps, lr)


def fit_sequence(
    lms2d: np.ndarray,  # [T, 68, 2] detected landmarks (pixel coordinates)
    basis: FaceBasis,
    H: int,
    W: int,
    focal_candidates=tuple(range(600, 1700, 100)),
    coarse_steps: int = 300,
    refine_steps: int = 700,
    coarse_every: int = 40,
    init_z: float = 7.0,  # camera-frame depth (+z in front of the camera)
    seed: int = 0,
    device=None,
) -> dict:
    """The landmark track: a focal search on every ``coarse_every``-th frame
    (one Adam fit per candidate, all candidates in one batched fit), then
    a joint fit of (id, exp, euler, trans) over all frames at the winning
    focal. → dict(euler [T, 3], trans [T, 3], focal, id, exp [T, e], loss)."""
    from geneface_tpu_torch import resolve_device

    dev = resolve_device(device)
    basis = basis.to(dev)
    lms = torch.as_tensor(np.asarray(lms2d, np.float32), device=dev)
    T = lms.shape[0]
    cxy = torch.tensor([W / 2.0, H / 2.0], dtype=torch.float32, device=dev)
    id_dim, exp_dim = basis.id_base.shape[1], basis.exp_base.shape[1]

    def init_params(lead: tuple, t: int):
        z = torch.zeros((), device=dev)
        return {
            "id": z.expand(*lead, id_dim).clone(),
            "exp": z.expand(*lead, t, exp_dim).clone(),
            "euler": z.expand(*lead, t, 3).clone(),
            "trans": torch.tensor([0.0, 0.0, init_z], device=dev).expand(*lead, t, 3).clone(),
        }

    sel = lms[::coarse_every]
    K = len(focal_candidates)
    focals = torch.tensor(focal_candidates, dtype=torch.float32, device=dev)
    with torch.profiler.record_function("gf::track"):
        _, losses = _fit_once(basis, sel, focals, cxy, init_params((K,), sel.shape[0]),
                              coarse_steps, 0.03)
        best = int(torch.argmin(losses))
        focal = float(focal_candidates[best])
        params, final_loss = _fit_once(basis, lms, torch.tensor(focal, device=dev), cxy,
                                       init_params((), T), refine_steps, 0.01)
    return {
        "euler": params["euler"].cpu().numpy(),
        "trans": params["trans"].cpu().numpy(),
        "id": params["id"].cpu().numpy(),
        "exp": params["exp"].cpu().numpy(),
        "focal": focal,
        "loss": float(final_loss),
    }


# ------------------------------------------------------ photometric stage ----
def _photo_loss(
    params, fb, frames_ds, lms, focal, cxy, H, W, scale,
    lambda_col, lambda_lan, lambda_lap, reg_id, reg_exp, z_tau,
):
    """Photometric + landmark + temporal-Laplacian objective → (total,
    {"col", "lan", "lap"})."""
    from geneface_tpu_torch.datagen.face_renderer import (
        photometric_loss,
        render_vertices_soft,
        sh9_irradiance,
        vertex_normals,
    )

    cam = _cam_geometry(fb, params["id"], params["exp"], params["euler"], params["trans"])
    T = cam.shape[0]
    albedo = (fb.tex_mean + params["tex"] @ fb.tex_base.T).reshape(1, -1, 3)
    normals = vertex_normals(cam, fb.tris)
    colors = albedo * sh9_irradiance(normals, params["light"])
    rgb, wmap = render_vertices_soft(cam, colors, focal, cxy, H, W, scale=scale, z_tau=z_tau)
    loss_col = photometric_loss(rgb, wmap, frames_ds)

    loss_lan = ((_project(cam[:, fb.lm_index], focal, cxy) - lms) ** 2).sum(-1).mean()

    # temporal smoothness: second difference of a vertex subset
    if T >= 3:
        sub = cam[:, :: max(1, cam.shape[1] // 256), :]
        lap = sub[:-2] - 2.0 * sub[1:-1] + sub[2:]
        loss_lap = (lap**2).sum(-1).mean()
    else:
        loss_lap = cam.new_zeros(())

    reg = reg_id * (params["id"] ** 2).mean() + reg_exp * (params["exp"] ** 2).mean()
    total = lambda_col * loss_col + lambda_lan * loss_lan + lambda_lap * loss_lap + reg
    return total, {"col": loss_col, "lan": loss_lan, "lap": loss_lap}


_PHOTO_KEYS = ("id", "exp", "euler", "trans", "tex", "light")


def _photo_fit(
    fb, frames_ds, lms, focal, cxy, init, *,
    steps: int, lr: float, H: int, W: int, scale: int,
    frozen: tuple = (),
    lambda_col: float = 1.0, lambda_lan: float = 1e-3,
    lambda_lap: float = 1.0, reg_id: float = 1e-3, reg_exp: float = 1e-3,
    z_tau: float = 0.05,
):
    """Adam over the photometric objective; ``frozen`` names the keys held
    fixed (("id", "tex") in the per-frame stage) → (params, the last step's
    terms, before its update)."""

    def loss_fn(p):
        total, aux = _photo_loss(p, fb, frames_ds, lms, focal, cxy, H, W, scale, lambda_col,
                                 lambda_lan, lambda_lap, reg_id, reg_exp, z_tau)
        return total, {k: v.detach() for k, v in aux.items()}

    with torch.profiler.record_function("gf::photo"):
        trained = tuple(k for k in _PHOTO_KEYS if k not in frozen)
        return _adam_loop(loss_fn, init, trained, steps, lr)


def refine_photometric(
    track: dict,  # fit_sequence output (euler/trans/id/exp/focal)
    full_basis,  # face_renderer.FullFaceBasis
    frames: np.ndarray,  # [T, H, W, 3] float in [0, 1]
    lms2d: np.ndarray,  # [T, 68, 2]
    H: int,
    W: int,
    *,
    scale: int = 4,
    global_steps: int = 150,
    frame_steps: int = 80,
    photo_batch: int = 50,
    lambda_col: float = 1.0,
    lambda_lan: float = 1e-3,
    lambda_lap: float = 1.0,
    z_tau: float = 0.05,
    device=None,
) -> dict:
    """Photometric refinement of a landmark-only track:

    1. global: on ``photo_batch`` evenly spaced frames, fit texture,
       per-frame SH light and id/exp/pose against the masked colour L2
       (plus landmarks and regularizers);
    2. per frame: with id and texture frozen and light started at the
       subset's mean, refine every frame's exp/euler/trans/light in chunks of
       ``photo_batch`` frames (the last chunk is the last ``photo_batch``
       frames, so it refines some frames again), with a temporal-Laplacian
       term.

    Returns the track with refined euler/trans/exp plus tex/light and
    ``photo_loss`` (the last chunk's colour term at its last step)."""
    from geneface_tpu_torch import resolve_device
    from geneface_tpu_torch.datagen.face_renderer import downsample_frames

    dev = resolve_device(device)
    fb = full_basis.to(dev)
    T = lms2d.shape[0]
    lms = torch.as_tensor(np.asarray(lms2d, np.float32), device=dev)
    cxy = torch.tensor([W / 2.0, H / 2.0], dtype=torch.float32, device=dev)
    focal = torch.tensor(float(track["focal"]), dtype=torch.float32, device=dev)
    tex_dim = fb.tex_base.shape[1]
    frames_ds_all = torch.as_tensor(
        downsample_frames(np.asarray(frames, np.float32), scale), device=dev)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    fit_kw = dict(H=H, W=W, scale=scale, lambda_col=lambda_col, lambda_lan=lambda_lan,
                  lambda_lap=lambda_lap, z_tau=z_tau)
    # ---- stage 1: global (frame subset)
    sel = np.linspace(0, T - 1, min(photo_batch, T)).astype(np.int64)
    init = {
        "id": f32(track["id"]),
        "exp": f32(track["exp"][sel]),
        "euler": f32(track["euler"][sel]),
        "trans": f32(track["trans"][sel]),
        "tex": torch.zeros(tex_dim, device=dev),
        "light": torch.zeros(len(sel), 27, device=dev),
    }
    fitted, aux = _photo_fit(fb, frames_ds_all[sel], lms[sel], focal, cxy, init,
                             steps=global_steps, lr=0.02, **fit_kw)
    id_para, tex = fitted["id"], fitted["tex"]
    light_mean = fitted["light"].mean(0)

    # ---- stage 2: per-frame refinement in chunks
    euler = np.asarray(track["euler"], np.float32).copy()
    trans = np.asarray(track["trans"], np.float32).copy()
    exp = np.asarray(track["exp"], np.float32).copy()
    light = np.tile(light_mean.cpu().numpy()[None], (T, 1))
    # the stage-1 results seed their frames
    for name, arr in (("euler", euler), ("trans", trans), ("exp", exp), ("light", light)):
        arr[sel] = fitted[name].cpu().numpy()

    B = min(photo_batch, T)
    for lo in range(0, T, B):
        ids = np.arange(lo, min(lo + B, T))
        if len(ids) < B:  # the JAX package keeps its jitted shape
            ids = np.arange(T - B, T)
        init = {"id": id_para, "exp": f32(exp[ids]), "euler": f32(euler[ids]),
                "trans": f32(trans[ids]), "tex": tex, "light": f32(light[ids])}
        fitted, aux = _photo_fit(fb, frames_ds_all[ids], lms[ids], focal, cxy, init,
                                 steps=frame_steps, lr=0.005, frozen=("id", "tex"), **fit_kw)
        for name, arr in (("euler", euler), ("trans", trans), ("exp", exp),
                          ("light", light)):
            arr[ids] = fitted[name].cpu().numpy()

    out = dict(track)
    out.update(euler=euler, trans=trans, exp=exp, id=id_para.cpu().numpy(),
               tex=tex.cpu().numpy(), light=light, photo_loss=float(aux["col"]))
    return out
