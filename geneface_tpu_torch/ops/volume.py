"""Classic NeRF volume rendering of the vanilla (AD-NeRF-style) family (port
of ``geneface_tpu/ops/volume.py``).

- :func:`raw2outputs`: alpha compositing with the background RGB put into
  the last sample (the AD-NeRF trick for composing onto a known background);
- :func:`sample_pdf`: inverse-CDF importance sampling;
- :func:`render_rays`: the stratified coarse pass and the fine pass on the
  sorted union of the coarse and importance samples.

RNG cannot be matched across frameworks, so every noise is a tensor
argument: ``t_rand [N, S]`` jitters the stratified samples (its last column
is pinned to 1.0, as the reference pins the last sample to its bin top),
``u [N, n_importance]`` draws the importance samples, and ``noise``/
``noise_fine [N, S]`` (standard normal) perturb sigma under
``raw_noise_std``. Without ``t_rand`` the render is deterministic: no
jitter, evenly spaced ``u`` and no sigma noise, as the JAX renderer with
``rng=None``. Sample positions are ``o + d·z`` rounded after the product and
after the sum, as the JAX package's eager ops and the torch reference give
them.

The device time of a render is named by ``gf::composite`` (the
compositing sums) and ``gf::sample_pdf`` (the CDF, the search and the sort
of the union) ranges; the field's own ranges are the caller's.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.profiler import record_function

__all__ = ["raw2outputs", "sample_pdf", "render_rays"]


def raw2outputs(
    raw: torch.Tensor,  # [N, S, 4] rgb logits + sigma logits
    z_vals: torch.Tensor,  # [N, S]
    rays_d: torch.Tensor,  # [N, 3]
    bc_rgb: torch.Tensor | None,  # [N, 3] background colour per ray
    noise: torch.Tensor | None = None,  # [N, S] standard normal
    raw_noise_std: float = 0.0,
    white_bkgd: bool = False,
) -> dict:
    """``alpha = 1 - exp(-(relu(sigma) + 1e-6)·dist·|d|)``; the last
    sample's RGB is ``bc_rgb``. → rgb_map, disp_map, acc_map, weights,
    depth_map, rgb_map_fg."""
    with record_function("gf::composite"):
        dists = z_vals[..., 1:] - z_vals[..., :-1]
        dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
        dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)

        rgb = torch.sigmoid(raw[..., :3])
        if bc_rgb is not None:
            rgb = torch.cat([rgb[:, :-1, :], bc_rgb[:, None, :]], dim=1)

        sigma = raw[..., 3]
        if raw_noise_std > 0.0 and noise is not None:
            sigma = sigma + noise * raw_noise_std

        alpha = 1.0 - torch.exp(-(torch.relu(sigma) + 1e-6) * dists)
        trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
        T = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
        weights = alpha * T

        rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
        rgb_map_fg = torch.sum(weights[:, :-1, None] * rgb[:, :-1, :], dim=-2)
        depth_map = torch.sum(weights * z_vals, dim=-1)
        acc_map = torch.sum(weights, dim=-1)
        disp_map = 1.0 / torch.clamp(depth_map / torch.clamp(acc_map, min=1e-10), min=1e-10)
        if white_bkgd:
            rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return {
        "rgb_map": rgb_map,
        "disp_map": disp_map,
        "acc_map": acc_map,
        "weights": weights,
        "depth_map": depth_map,
        "rgb_map_fg": rgb_map_fg,
    }


def sample_pdf(
    bins: torch.Tensor,  # [N, B] bin edges
    weights: torch.Tensor,  # [N, B-1]
    n_samples: int,
    u: torch.Tensor | None = None,  # [N, n_samples] uniform in [0, 1)
) -> torch.Tensor:
    """Inverse-CDF sampling of ``n_samples`` per ray: at ``u``, or without
    it at ``n_samples`` evenly spaced points of [0, 1]. A bin whose CDF
    step is under 1e-5 takes its lower edge."""
    with record_function("gf::sample_pdf"):
        weights = weights + 1e-5
        pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
        cdf = torch.cumsum(pdf, dim=-1)
        cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [N, B]

        if u is None:
            u = torch.linspace(0.0, 1.0, n_samples, device=cdf.device, dtype=cdf.dtype)
            u = u.expand(cdf.shape[:-1] + (n_samples,))
        u = u.contiguous()

        inds = torch.searchsorted(cdf.contiguous(), u, right=True)
        below = torch.clamp(inds - 1, min=0)
        above = torch.clamp(inds, max=cdf.shape[-1] - 1)

        cdf_b = torch.gather(cdf, -1, below)
        cdf_a = torch.gather(cdf, -1, above)
        bins_b = torch.gather(bins, -1, below)
        bins_a = torch.gather(bins, -1, above)

        denom = cdf_a - cdf_b
        denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
        t = (u - cdf_b) / denom
        return bins_b + t * (bins_a - bins_b)


def render_rays(
    query_fn: Callable[[torch.Tensor, bool], torch.Tensor],
    rays_o: torch.Tensor,  # [N, 3]
    rays_d: torch.Tensor,  # [N, 3]
    near,
    far,
    bc_rgb: torch.Tensor | None,
    n_samples: int,
    n_importance: int = 0,
    t_rand: torch.Tensor | None = None,  # [N, n_samples] uniform
    u: torch.Tensor | None = None,  # [N, n_importance] uniform
    noise: torch.Tensor | None = None,  # [N, n_samples] standard normal
    noise_fine: torch.Tensor | None = None,  # [N, n_samples + n_importance]
    raw_noise_std: float = 0.0,
    white_bkgd: bool = False,
    linear_disp: bool = False,
    z_samples: torch.Tensor | None = None,  # [N, n_importance]
) -> dict:
    """Coarse (+ fine) hierarchical rendering. ``query_fn(pts [N, S, 3],
    fine) -> raw [N, S, 4]`` evaluates the field (the caller closes over the
    condition and the view directions). ``t_rand`` turns the jitter on;
    ``u`` is read only then (the deterministic render samples the PDF at
    evenly spaced points). ``z_samples`` replaces the importance samples
    (another render's ``out["z_samples"]``: the same fine pass where the
    PDF's ``denom < 1e-5`` switch could fall the other way)."""
    N = rays_o.shape[0]
    dev = rays_o.device
    near = torch.as_tensor(near, dtype=torch.float32, device=dev).expand(N, 1)
    far = torch.as_tensor(far, dtype=torch.float32, device=dev).expand(N, 1)

    t_vals = torch.linspace(0.0, 1.0, n_samples, device=dev)
    if linear_disp:
        z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    else:
        z_vals = near * (1.0 - t_vals) + far * t_vals  # [N, S]

    perturb = t_rand is not None
    if perturb:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        # the last stratified sample sits at its bin top
        t_rand = torch.cat([t_rand[..., :-1], torch.ones_like(t_rand[..., -1:])], dim=-1)
        z_vals = lower + (upper - lower) * t_rand
    else:
        noise = noise_fine = None

    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    raw = query_fn(pts, False)
    coarse = raw2outputs(raw, z_vals, rays_d, bc_rgb, noise, raw_noise_std, white_bkgd)

    out = {
        "rgb_map": coarse["rgb_map"],
        "disp_map": coarse["disp_map"],
        "acc_map": coarse["acc_map"],
        "rgb_map_fg": coarse["rgb_map_fg"],
        "last_weight": coarse["weights"][..., -1],
        "depth_map": coarse["depth_map"],
    }
    if n_importance > 0:
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        if z_samples is None:
            z_samples = sample_pdf(
                z_mid, coarse["weights"][..., 1:-1], n_importance, u=u if perturb else None,
            )
        z_samples = z_samples.detach()
        with record_function("gf::sample_pdf"):
            z_all = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1).values
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_all[..., None]
        raw_f = query_fn(pts, True)
        fine = raw2outputs(raw_f, z_all, rays_d, bc_rgb, noise_fine, raw_noise_std, white_bkgd)
        out.update(
            rgb_map=fine["rgb_map"],
            disp_map=fine["disp_map"],
            acc_map=fine["acc_map"],
            rgb_map_fg=fine["rgb_map_fg"],
            last_weight=fine["weights"][..., -1],
            depth_map=fine["depth_map"],
            rgb_map_coarse=coarse["rgb_map"],
            disp_map_coarse=coarse["disp_map"],
            accu_map_coarse=coarse["acc_map"],
            rgb_map_fg0=coarse["rgb_map_fg"],
            last_weight0=coarse["weights"][..., -1],
            z_std=torch.std(z_samples, dim=-1, correction=0),
            z_samples=z_samples,
        )
    return out
