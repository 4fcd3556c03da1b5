"""Static-shape kNN neighborhoods for the SE(3) track (port of the dense parts
of rosettafold_tpu/ops/knn.py)."""

from __future__ import annotations

import torch


def ca_pairwise_distance(ca: torch.Tensor) -> torch.Tensor:
    """(B, L, 3) -> (B, L, L) Euclidean distances."""
    diff = ca[:, :, None, :] - ca[:, None, :, :]
    return torch.sqrt((diff * diff).sum(-1) + 1e-12)


def knn_adjacency(xyz, aa_idx, n_neighbors: int, kmin: int = 9, ca_index: int = 1,
                  exclude_self: bool = True) -> torch.Tensor:
    """Boolean adjacency cond[b, i, j]: edge i -> j exists iff j is among the
    n_neighbors nearest CAs of i, or |aa_i - aa_j| < kmin; self edges are
    excluded by default. (B, L, L) bool, src-major.

    Ties in distance go to the lower index, as `lax.top_k` breaks them: the
    neighbors come from a stable ascending sort."""
    B, L = xyz.shape[:2]
    ca = xyz[:, :, ca_index]
    pdist = ca_pairwise_distance(ca)
    eye = torch.eye(L, dtype=pdist.dtype, device=pdist.device)
    pdist = pdist + eye[None] * 1e3
    sep = (aa_idx[:, None, :] - aa_idx[:, :, None]).abs().to(pdist.dtype)
    sep = sep + eye[None] * 999.9

    k = min(n_neighbors, L)
    nbr_idx = torch.sort(pdist, dim=-1, stable=True).indices[..., :k]
    adj = torch.zeros((B, L, L), dtype=torch.bool, device=xyz.device)
    adj.scatter_(2, nbr_idx, True)
    cond = adj | (sep < kmin)
    if not exclude_self:
        return cond
    return cond & ~torch.eye(L, dtype=torch.bool, device=xyz.device)[None]


def incoming_mask(cond: torch.Tensor) -> torch.Tensor:
    """in_mask[b, j, i] = cond[b, i, j] (aggregation at dst over incoming edges)."""
    return cond.transpose(1, 2)
