"""FeedForward and FAVOR+ self-attention (port of the non-fused path of
rosettafold_tpu/models/attention.py)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import performer as favor
from .layers import FUSED_MIN_L, Dense, require_unported


class FeedForward(nn.Module):
    """Linear -> ReLU -> Dropout -> Linear."""

    def __init__(self, d_emb: int, d_ff: int, p_dropout: float = 0.1, dtype=None):
        super().__init__()
        self.fc1 = Dense(d_emb, d_ff, dtype=dtype)
        self.fc2 = Dense(d_ff, d_emb, dtype=dtype)
        self.dropout = nn.Dropout(p_dropout)

    def forward(self, x):
        return self.fc2(self.dropout(torch.relu(self.fc1(x))))


class PerformerSelfAttention(nn.Module):
    """FAVOR+ self-attention over the second-to-last axis (or axis 1 of a 4D
    (B, L1, L2, D) input with attend_axis=1): q/k/v projections to
    heads*dim_head, a fixed random-feature projection (a registered buffer
    built from `feature_seed`), output projection, dropout on the output.

    With attn_impl="pallas" the JAX package runs the generalized mode through
    the fused kernel C from L >= 128; that kernel is not ported, so this
    module raises there instead of running the plain math."""

    def __init__(self, dim: int, heads: int, dim_head: int = 64,
                 nb_features: Optional[int] = None,
                 generalized_attention: bool = False, p_dropout: float = 0.0,
                 feature_seed: int = 42, kernel_eps: float = 1e-3,
                 softmax_eps: float = 1e-4, attn_impl: str = "xla",
                 attend_axis: int = -2, dtype=None):
        super().__init__()
        assert attend_axis in (-2, 1)
        self.heads, self.dim_head = heads, dim_head
        self.generalized = generalized_attention
        self.kernel_eps, self.softmax_eps = kernel_eps, softmax_eps
        self.attn_impl, self.attend_axis = attn_impl, attend_axis
        inner = heads * dim_head
        m = nb_features or favor.default_nb_features(dim_head)
        self.register_buffer("projection", torch.from_numpy(
            favor.gaussian_orthogonal_matrix(m, dim_head, seed=feature_seed)),
            persistent=False)
        self.to_q = Dense(dim, inner, bias=False, dtype=dtype)
        self.to_k = Dense(dim, inner, bias=False, dtype=dtype)
        self.to_v = Dense(dim, inner, bias=False, dtype=dtype)
        self.to_out = Dense(inner, dim, dtype=dtype)
        self.dropout = nn.Dropout(p_dropout)

    def _split_heads(self, t):  # (..., L, h*dh) -> (..., h, L, dh)
        t = t.reshape(*t.shape[:-1], self.heads, self.dim_head)
        return t.movedim(-2, -3)

    def forward(self, x):
        if self.attend_axis == 1:
            assert x.ndim == 4
        attended = x.shape[1] if self.attend_axis == 1 else x.shape[-2]
        if (self.attn_impl == "pallas" and self.generalized
                and attended >= FUSED_MIN_L):
            require_unported("fused_performer", attended)
        if self.attend_axis == 1:
            x = x.transpose(1, 2)
        q = self._split_heads(self.to_q(x))
        k = self._split_heads(self.to_k(x))
        v = self._split_heads(self.to_v(x))
        out = favor.favor_attention(
            q, k, v, self.projection, generalized=self.generalized,
            kernel_eps=self.kernel_eps, softmax_eps=self.softmax_eps)
        out = out.movedim(-3, -2)
        out = self.to_out(out.reshape(*out.shape[:-2], -1))
        if self.attend_axis == 1:
            out = out.transpose(1, 2)
        return self.dropout(out)
