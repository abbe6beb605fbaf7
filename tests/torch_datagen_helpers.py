"""Shared inputs of the datagen parity tests: a seeded sphere-cap "face
shell" 3DMM with a grid triangulation (numpy), as the JAX package's own
photometric tests build it, and its JAX and port forms."""

import numpy as np


def sphere_cap(rng, nu=20, nv=20, id_dim=6, exp_dim=4, tex_dim=3):
    """→ dict of numpy arrays: mean, id_base, exp_base, tex_mean, tex_base,
    tris (int32), lm_index (int32); radius 0.8, facing -z."""
    r = 0.8
    th = np.linspace(-0.6, 0.6, nu)
    ph = np.linspace(-0.7, 0.7, nv)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    x = r * np.sin(tt)
    y = r * np.sin(pp) * 1.15
    z = -r * np.cos(tt) * np.cos(pp)
    mean = np.stack([x, y, z], -1).reshape(-1)
    V = nu * nv
    tris = []
    for i in range(nu - 1):
        for j in range(nv - 1):
            a, b = i * nv + j, i * nv + j + 1
            c, d = (i + 1) * nv + j, (i + 1) * nv + j + 1
            tris += [(a, b, c), (b, d, c)]
    albedo = np.stack([0.55 + 0.35 * np.sin(4.0 * x) * np.cos(3.0 * y),
                       0.45 + 0.30 * np.cos(5.0 * x + 1.0),
                       0.40 + 0.30 * np.sin(3.0 * y + 0.5)], -1).reshape(-1)
    return {
        "mean": mean.astype(np.float32),
        "id_base": (rng.randn(V * 3, id_dim) * 0.01).astype(np.float32),
        "exp_base": (rng.randn(V * 3, exp_dim) * 0.01).astype(np.float32),
        "tex_mean": albedo.astype(np.float32),
        "tex_base": (rng.randn(V * 3, tex_dim) * 0.01).astype(np.float32),
        "tris": np.asarray(tris, np.int32),
        "lm_index": np.linspace(0, V - 1, 68).astype(np.int32),
    }


def landmark_rows(lm_index):
    return np.stack([3 * np.asarray(lm_index) + k for k in range(3)], -1).reshape(-1)


def jax_full_basis(b):
    import jax.numpy as jnp

    from geneface_tpu.datagen.face_renderer import FullFaceBasis

    return FullFaceBasis(**{k: jnp.asarray(v) for k, v in b.items()})


def torch_full_basis(b):
    import torch

    from geneface_tpu_torch.datagen.face_renderer import FullFaceBasis

    return FullFaceBasis(**{k: torch.as_tensor(v if v.dtype != np.int32 else v.astype(np.int64))
                            for k, v in b.items()})


def jax_lm_basis(b):
    import jax.numpy as jnp

    from geneface_tpu.datagen.face_tracker import FaceBasis

    sel = landmark_rows(b["lm_index"])
    return FaceBasis(mean=jnp.asarray(b["mean"][sel]), id_base=jnp.asarray(b["id_base"][sel]),
                     exp_base=jnp.asarray(b["exp_base"][sel]))


def torch_lm_basis(b):
    import torch

    from geneface_tpu_torch.datagen.face_tracker import FaceBasis

    sel = landmark_rows(b["lm_index"])
    return FaceBasis(mean=torch.as_tensor(b["mean"][sel]),
                     id_base=torch.as_tensor(b["id_base"][sel]),
                     exp_base=torch.as_tensor(b["exp_base"][sel]))


def smooth_track(rng, T, id_dim, exp_dim):
    """A smooth head motion in front of the camera (z about 7)."""
    t = np.arange(T)
    euler = np.stack([0.12 * np.sin(t * 0.8), 0.10 * np.cos(t * 0.7), 0.05 * np.sin(t * 0.5)], -1)
    trans = np.stack([0.06 * np.sin(t * 0.6), 0.05 * np.cos(t * 0.9),
                      7.0 + 0.15 * np.sin(t * 0.4)], -1)
    return {"id": (rng.randn(id_dim) * 0.2).astype(np.float32),
            "exp": (rng.randn(T, exp_dim) * 0.2).astype(np.float32),
            "euler": euler.astype(np.float32), "trans": trans.astype(np.float32)}


def max_rel(got, ref):
    """max |got - ref| / max |ref|."""
    got, ref = (np.asarray(x.detach() if hasattr(x, "detach") else x, np.float64)
                for x in (got, ref))
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))
