"""FAVOR+ linear attention (port of rosettafold_tpu/ops/performer.py).

`gaussian_orthogonal_matrix` is the JAX package's numpy code, copied so that
this package never imports jax; tests hold the two bit-equal. The feature maps
and `linear_attention` keep the JAX functions' dtype policy: bf16 operands are
contracted with float32 accumulation (`preferred_element_type=f32` in JAX),
which here means upcasting the bf16 values to float32 before the product.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def default_nb_features(dim_head: int) -> int:
    return int(dim_head * math.ceil(math.log(dim_head)))


def gaussian_orthogonal_matrix(
    nb_rows: int, nb_cols: int, seed: int, scaling: int = 0
) -> np.ndarray:
    """Random features matrix with orthogonal blocks (FAVOR+ Sec. 3.2), float64
    on the host, returned as float32. scaling=0: rows rescaled by norms of iid
    gaussian rows; scaling=1: all rows scaled by sqrt(nb_cols)."""
    rng = np.random.default_rng(seed)
    n_full = nb_rows // nb_cols
    blocks = []
    for _ in range(n_full):
        q, _ = np.linalg.qr(rng.standard_normal((nb_cols, nb_cols)))
        blocks.append(q.T)
    rem = nb_rows - n_full * nb_cols
    if rem > 0:
        q, _ = np.linalg.qr(rng.standard_normal((nb_cols, nb_cols)))
        blocks.append(q.T[:rem])
    mat = np.concatenate(blocks, axis=0)

    if scaling == 0:
        multiplier = np.linalg.norm(rng.standard_normal((nb_rows, nb_cols)), axis=1)
    elif scaling == 1:
        multiplier = np.full((nb_rows,), math.sqrt(nb_cols))
    else:
        raise ValueError(f"invalid scaling {scaling}")
    return (multiplier[:, None] * mat).astype(np.float32)


def _f32_einsum(eq, a, b):
    """einsum of (possibly bf16) operands with float32 accumulation."""
    return torch.einsum(eq, a.float(), b.float())


def softmax_kernel_features(data, projection, *, is_query: bool, eps: float = 1e-4):
    """Positive softmax-kernel features exp(w^T x' - |x'|^2/2 - stab)/sqrt(m).

    data (..., L, d); projection (m, d) -> (..., L, m) in data's dtype. Queries
    stabilize with a per-position max, keys with a global max; the stabilizer
    carries no gradient (JAX's stop_gradient)."""
    d = data.shape[-1]
    m = projection.shape[0]
    data_normalizer = d ** -0.25
    ratio = m ** -0.5
    proj = _f32_einsum("...ld,md->...lm", data_normalizer * data,
                       projection.to(data.dtype))
    diag = (data.float() ** 2).sum(-1, keepdim=True) * (data_normalizer ** 2) / 2.0
    if is_query:
        stab = proj.amax(-1, keepdim=True)
    else:
        stab = proj.amax(dim=(-1, -2), keepdim=True)
    feats = ratio * (torch.exp(proj - diag - stab.detach()) + eps)
    return feats.to(data.dtype)


def generalized_kernel_features(data, projection: Optional[torch.Tensor], *,
                                kernel_eps: float = 1e-3):
    """Generalized (ReLU) attention features relu(x' W^T) + eps."""
    d = data.shape[-1]
    data_normalizer = d ** -0.25
    if projection is None:
        return torch.relu(data_normalizer * data) + kernel_eps
    proj = torch.einsum("...ld,md->...lm", data_normalizer * data,
                        projection.to(data.dtype))
    return torch.relu(proj) + kernel_eps


def linear_attention(q_feat, k_feat, v):
    """Non-causal linear attention. q_feat/k_feat (..., L, m), v (..., L, e).

    Uses the quadratic association (phi_q phi_k^T) v when the attended axis is
    short (L(m+e) < 2me), phi_q (phi_k^T v) otherwise: the same branch rule as
    the JAX function, so both frameworks round alike."""
    L, m = q_feat.shape[-2], q_feat.shape[-1]
    e = v.shape[-1]
    if L * (m + e) < 2 * m * e:
        a = _f32_einsum("...lm,...km->...lk", q_feat, k_feat)
        d_inv = 1.0 / (a.sum(-1) + 1e-12)
        out = _f32_einsum("...lk,...ke->...le", a.to(v.dtype), v)
        return (out * d_inv[..., None]).to(v.dtype)
    k_sum = k_feat.float().sum(-2)
    d_inv = 1.0 / (_f32_einsum("...lm,...m->...l", q_feat, k_sum.to(q_feat.dtype))
                   + 1e-12)
    context = torch.einsum("...lm,...le->...me", k_feat, v)
    out = _f32_einsum("...me,...lm->...le", context, q_feat)
    return (out * d_inv[..., None]).to(v.dtype)


def favor_attention(q, k, v, projection, *, generalized: bool = False,
                    kernel_eps: float = 1e-3, softmax_eps: float = 1e-4):
    """Full FAVOR+ attention on per-head tensors (..., L, d_head)."""
    if generalized:
        q_feat = generalized_kernel_features(q, projection, kernel_eps=kernel_eps)
        k_feat = generalized_kernel_features(k, projection, kernel_eps=kernel_eps)
    else:
        q_feat = softmax_kernel_features(q, projection, is_query=True, eps=softmax_eps)
        k_feat = softmax_kernel_features(k, projection, is_query=False, eps=softmax_eps)
    return linear_attention(q_feat, k_feat, v)
