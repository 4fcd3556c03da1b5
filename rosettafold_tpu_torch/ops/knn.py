"""Static-shape kNN neighborhoods for the SE(3) track (port of
rosettafold_tpu/ops/knn.py): the dense (L, L) adjacency, and the dst-major
(B, L, S) index layouts of the long-chain paths ("gather", "bucket").

Every top-k is a stable sort cut to k, so ties go to the lower index, as
`lax.top_k` breaks them: the indices are bit-equal to JAX's, ties included.
`torch.topk` promises no order among ties, and a bucket that overflows drops
its last slots, so a different order would change the edge set.
"""

from __future__ import annotations

from typing import Optional

import torch


def ca_pairwise_distance(ca: torch.Tensor) -> torch.Tensor:
    """(B, L, 3) -> (B, L, L) Euclidean distances."""
    diff = ca[:, :, None, :] - ca[:, None, :, :]
    return torch.sqrt((diff * diff).sum(-1) + 1e-12)


def _nearest(pdist: torch.Tensor, k: int) -> torch.Tensor:
    """(B, L, k) indices of the k smallest entries of each row, lower index
    first among ties (`lax.top_k(-pdist, k)`)."""
    return torch.sort(pdist, dim=-1, stable=True).indices[..., :k].contiguous()


def knn_adjacency(xyz, aa_idx, n_neighbors: int, kmin: int = 9, ca_index: int = 1,
                  exclude_self: bool = True, k_dynamic: Optional[int] = None) -> torch.Tensor:
    """Boolean adjacency cond[b, i, j]: edge i -> j exists iff j is among the
    n_neighbors nearest CAs of i (the first k_dynamic of them, if given), or
    |aa_i - aa_j| < kmin; self edges are excluded by default. (B, L, L) bool,
    src-major."""
    B, L = xyz.shape[:2]
    ca = xyz[:, :, ca_index]
    pdist = ca_pairwise_distance(ca)
    eye = torch.eye(L, dtype=pdist.dtype, device=pdist.device)
    pdist = pdist + eye[None] * 1e3
    sep = (aa_idx[:, None, :] - aa_idx[:, :, None]).abs().to(pdist.dtype)
    sep = sep + eye[None] * 999.9

    k = min(n_neighbors, L)
    nbr_idx = _nearest(pdist, k)
    adj = torch.zeros((B, L, L), dtype=torch.bool, device=xyz.device)
    if k_dynamic is not None:  # only the first k_dynamic (closest) slots
        nbr_idx = nbr_idx[..., :min(k_dynamic, L)]
    adj.scatter_(2, nbr_idx, True)
    cond = adj | (sep < kmin)
    if not exclude_self:
        return cond
    return cond & ~torch.eye(L, dtype=torch.bool, device=xyz.device)[None]


def incoming_mask(cond: torch.Tensor) -> torch.Tensor:
    """in_mask[b, j, i] = cond[b, i, j] (aggregation at dst over incoming edges)."""
    return cond.transpose(1, 2)


def knn_gather_indices(xyz, aa_idx, n_neighbors: int, kmin: int = 9, ca_index: int = 1,
                       k_dynamic: Optional[int] = None):
    """(B, L, S) neighbor indices + validity mask of the "gather" layout: for
    each destination j, S = min(K, L) + 2*(kmin-1) slots hold j's K nearest
    CAs, then the sequence band j-(kmin-1) .. j+(kmin-1). Band slots out of
    range, beyond the kmin separation, or repeating a valid top-K slot are
    masked; self is excluded. Returns (idx int32, valid bool)."""
    B, L = xyz.shape[:2]
    dev = xyz.device
    ca = xyz[:, :, ca_index]
    pdist = ca_pairwise_distance(ca)
    pdist = pdist + torch.eye(L, dtype=pdist.dtype, device=dev)[None] * 1e3

    k = min(n_neighbors, L)
    topk_idx = _nearest(pdist, k)                                   # (B, L, k)
    topk_valid = topk_idx != torch.arange(L, device=dev)[None, :, None]
    if k_dynamic is not None:  # only the first k_dynamic (closest) slots
        topk_valid = topk_valid & (torch.arange(k, device=dev) < min(k_dynamic, L))

    offsets = torch.tensor([o for o in range(-(kmin - 1), kmin) if o != 0], device=dev)
    band_idx = torch.arange(L, device=dev)[:, None] + offsets[None]  # (L, 2*(kmin-1))
    band_valid = (band_idx >= 0) & (band_idx < L)
    band_idx = band_idx.clamp(0, L - 1).expand(B, -1, -1)
    aa_band = torch.gather(aa_idx, 1, band_idx.reshape(B, -1)).reshape(band_idx.shape)
    band_valid = band_valid & ((aa_band - aa_idx[:, :, None]).abs() < kmin)
    dup = ((band_idx[..., None] == topk_idx[:, :, None, :])
           & topk_valid[:, :, None, :]).any(-1)
    band_valid = band_valid & ~dup

    idx = torch.cat([topk_idx, band_idx], dim=-1)
    valid = torch.cat([topk_valid, band_valid], dim=-1)
    return idx.to(torch.int32).contiguous(), valid.contiguous()


def knn_bucket_indices(xyz, aa_idx, n_neighbors: int, kmin: int = 9, ca_index: int = 1,
                       capacity: Optional[int] = None, k_dynamic: Optional[int] = None):
    """The exact incoming neighborhoods of `knn_adjacency` (self excluded) on the
    dst-major (B, L, C) layout: each destination's incoming sources, band
    edges first, then nearest first. Edges past C are dropped (the furthest
    non-band ones) and counted. C = capacity, by default min(2*K, L) +
    2*(kmin-1) with K = min(n_neighbors, L) (it covers the reverse-kNN
    indegrees JAX measured, ~2.2*K); at most L.

    Returns (src_idx (B, L, C) int32, valid (B, L, C) bool, overflow (B,)
    int32: true edges beyond capacity, 0 when exact). The indices of invalid
    slots are whatever the sort leaves there, as in JAX; readers mask them."""
    B, L = xyz.shape[:2]
    cond = knn_adjacency(xyz, aa_idx, n_neighbors, kmin, ca_index, exclude_self=True,
                         k_dynamic=k_dynamic)
    in_mask = incoming_mask(cond)                                   # (B, j, i)
    pdist = ca_pairwise_distance(xyz[:, :, ca_index])
    sep = (aa_idx[:, None, :] - aa_idx[:, :, None]).abs()
    band_bonus = torch.where(sep < kmin, 1e4, 0.0).to(pdist.dtype)  # band edges never dropped
    score = torch.where(in_mask, band_bonus - pdist,
                        torch.full_like(pdist, float("-inf")))
    k = min(n_neighbors, L)
    C = min(capacity if capacity is not None else min(2 * k, L) + 2 * (kmin - 1), L)
    val, src_idx = torch.sort(score, dim=-1, descending=True, stable=True)
    # contiguous: the sort may return transposed strides, kernel B reads rows
    src_idx = src_idx[..., :C].to(torch.int32).contiguous()
    valid = torch.isfinite(val[..., :C]).contiguous()
    overflow = (in_mask.sum(dim=(1, 2)) - valid.sum(dim=(1, 2))).to(torch.int32)
    return src_idx, valid, overflow
