"""Locally-linear-embedding projection onto the landmark manifold of the
training video (port of ``geneface_tpu/models/postnet/lle.py``): the k
nearest database rows (``torch.topk`` on float32 squared distances), then
the affine-combination weights from a batched ``torch.linalg.solve``.

The weights are solved in float64 (the JAX package solves in float32): the
landmarks of a short or still video span few dimensions, so the Gram
matrix of the neighbour differences is singular but for its ridge (1e-6 of
its trace), and float32 rounding of its products is then as large as the
ridge, and the fused rows would move with the order of the sums (torch
against XLA, the card against the CPU). In float64 they do not; the result
is returned in the input's dtype.
"""

from __future__ import annotations

import torch

__all__ = ["find_k_nearest_neighbors", "solve_lle_projection", "compute_lle_projection"]


def find_k_nearest_neighbors(feats, feat_database, K: int = 10):
    """feats [N, C], database [M, C] → indices [N, K] of the nearest rows
    (ties may come in another order than ``jax.lax.top_k``'s)."""
    d2 = (
        (feats**2).sum(-1, keepdim=True)
        + (feat_database**2).sum(-1)[None, :]
        - 2.0 * feats @ feat_database.T
    )
    return torch.topk(-d2, K, dim=-1).indices


def solve_lle_projection(feat, feat_base):
    """feat [N, C], feat_base [N, K, C] → (feat_fuse [N, C], weights [N, K]):
    ``min ||feat - Σ w_i base_i||`` subject to ``Σ w_i = 1``."""
    N, K, C = feat_base.shape
    if K == 1:
        return feat_base[:, 0], torch.ones(N, 1, dtype=feat.dtype, device=feat.device)
    dtype = feat.dtype
    feat, feat_base = feat.double(), feat_base.double()
    B = feat - feat_base[:, 0]  # [N, C]
    A = (feat_base[:, 1:] - feat_base[:, :1]).transpose(1, 2)  # [N, C, K-1]
    AT = A.transpose(1, 2)
    ATA = AT @ A  # [N, K-1, K-1]
    # ridge scaled by the Gram trace: duplicate neighbours make ATA singular
    tr = torch.diagonal(ATA, dim1=-2, dim2=-1).sum(-1)[:, None, None]
    eye = torch.eye(K - 1, dtype=torch.float64, device=feat.device)[None]
    ATA = ATA + (1e-6 * tr / (K - 1) + 1e-8) * eye
    X = torch.linalg.solve(ATA, AT @ B[..., None])[..., 0]  # [N, K-1]
    weights = torch.cat([1.0 - X.sum(-1, keepdim=True), X], dim=-1)
    return torch.einsum("nk,nkc->nc", weights, feat_base).to(dtype), weights.to(dtype)


def compute_lle_projection(feats, feat_database, K: int = 10):
    """→ (feat_fuse [N, C], weights [N, K])."""
    idx = find_k_nearest_neighbors(feats, feat_database, K)
    return solve_lle_projection(feats, feat_database[idx])
