"""Pair-track modules (port of rosettafold_tpu/models/pair.py, unchunked).

With attn_impl="pallas" the JAX package runs the fused outer-product (E),
3x3 conv (F), FAVOR+ (C) and FF (D) kernels from L >= 128. Those are not
ported yet, so these modules raise there; below L = 128 JAX runs plain XLA
math, and so does this port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .attention import FeedForward, PerformerSelfAttention
from .layers import FUSED_MIN_L, ConvNHWC, Dense, LayerNorm, layer_norm, require_unported
from .msa import PositionWiseWeightFactor
from .resnet import InstanceNorm2d

LN_EPS = 1e-5


def symmetrize(x: torch.Tensor) -> torch.Tensor:
    """0.5 * (x + x^T) over the pair axes."""
    return 0.5 * (x + x.transpose(1, 2))


class OuterProductMean(nn.Module):
    """Outer-product sum over MSA rows -> pair features, then LN + Linear."""

    def __init__(self, in_features: int, out_features: int, impl: str = "xla", dtype=None):
        super().__init__()
        self.in_features, self.impl, self.dtype = in_features, impl, dtype
        self.ln = LayerNorm(in_features ** 2, LN_EPS)
        self.to_out = Dense(in_features ** 2, out_features, dtype=dtype)

    def forward(self, x, y=None):
        y = x if y is None else y
        if self.dtype is not None:
            x, y = x.to(self.dtype), y.to(self.dtype)
        L = x.shape[2]
        if self.impl == "pallas" and L >= FUSED_MIN_L:
            require_unported("outer_product", L)
        op = torch.einsum("bniu,bnjv->bijuv", x, y)
        op = op.reshape(*op.shape[:3], self.in_features ** 2)
        return self.to_out(self.ln(op))


class PairUpdateWithMsa(nn.Module):
    """MSA -> pair update: position-weighted outer product, tiled 1D MSA
    features, LN(pair) and the tied-attention map, projected by `resnet_in`
    (applied as a sum of per-part projections, as JAX does) and one 2-conv
    residual block (3x3, InstanceNorm, ELU)."""

    def __init__(self, d_msa: int, d_proj: int = 32, d_pair: int = 288, n_heads: int = 12,
                 p_dropout: float = 0.1, attn_impl: str = "xla", dtype=None):
        super().__init__()
        self.d_pair, self.attn_impl, self.dtype = d_pair, attn_impl, dtype
        self.proj_msa_ln_in = LayerNorm(d_msa, LN_EPS)
        self.proj_msa = Dense(d_msa, d_proj)
        self.proj_msa_ln_out = LayerNorm(d_proj, LN_EPS)
        self.poswise_weight = PositionWiseWeightFactor(d_proj, 1, p_dropout)
        self.outer_product_mean = OuterProductMean(d_proj, d_pair, impl=attn_impl, dtype=dtype)
        self.ln_coevol_feat = LayerNorm(d_pair, LN_EPS)
        self.ln_pair = LayerNorm(d_pair, LN_EPS)
        self.d2p = 2 * d_proj
        self.resnet_in = Dense(d_pair + 2 * self.d2p + d_pair + n_heads, d_pair)
        self.conv1 = ConvNHWC(d_pair, d_pair, 3, dtype=dtype)
        self.conv2 = ConvNHWC(d_pair, d_pair, 3, dtype=dtype)
        self.in1 = InstanceNorm2d(d_pair)
        self.in2 = InstanceNorm2d(d_pair)
        self.dropout = nn.Dropout(p_dropout)

    def forward(self, msa, pair, att):
        L = msa.shape[2]
        if self.attn_impl == "pallas" and L >= FUSED_MIN_L:
            require_unported("conv3x3", L)
        m = self.proj_msa_ln_out(self.proj_msa(self.proj_msa_ln_in(msa)))
        w = self.poswise_weight(m)[:, :, 0]  # (B, N, L, 1)
        coevol = self.outer_product_mean(m, m * w)
        msa_1d = torch.cat([m.sum(1), m[:, 0]], dim=-1)  # (B, L, 2p)

        ct = self.dtype or torch.float32
        kern = self.resnet_in.weight.t().to(ct)  # flax layout (in, out)
        dp, d2p = self.d_pair, self.d2p
        w_coevol, w_row = kern[:dp], kern[dp:dp + d2p]
        w_col, w_pair = kern[dp + d2p:dp + 2 * d2p], kern[dp + 2 * d2p:2 * dp + 2 * d2p]
        w_att = kern[2 * dp + 2 * d2p:]
        row_proj = msa_1d.to(ct) @ w_row
        col_proj = msa_1d.to(ct) @ w_col
        x = (self.ln_coevol_feat(coevol).to(ct) @ w_coevol
             + self.ln_pair(pair).to(ct) @ w_pair
             + att.to(ct) @ w_att
             + row_proj[:, :, None, :]
             + col_proj[:, None, :, :]
             + self.resnet_in.bias.to(ct))

        y = F.elu(self.in1(self.conv1(x)))
        y = self.in2(self.conv2(self.dropout(y)))
        out = F.elu(x.float() + y)
        return out if self.dtype is None else out.to(self.dtype)


class PairUpdateWithAxialAttentionLayer(nn.Module):
    """Axial FAVOR+ (generalized ReLU kernel) over the pair map: row step
    (attend over axis 1), column step (axis 2), each a pre-LN residual, then a
    pre-LN FF residual."""

    def __init__(self, d_pair: int, d_ff: int, n_heads: int = 8, p_dropout: float = 0.1,
                 feature_seed: int = 42, performer_dim_head: int = 64,
                 attn_impl: str = "xla", dtype=None):
        super().__init__()
        self.attn_impl, self.dtype = attn_impl, dtype
        kw = dict(dim=d_pair, heads=n_heads, dim_head=performer_dim_head,
                  p_dropout=p_dropout, generalized_attention=True,
                  attn_impl=attn_impl, dtype=dtype)
        self.row_attn = PerformerSelfAttention(feature_seed=feature_seed, attend_axis=1, **kw)
        self.col_attn = PerformerSelfAttention(feature_seed=feature_seed + 1, **kw)
        self.ln_row = LayerNorm(d_pair, LN_EPS)
        self.ln_col = LayerNorm(d_pair, LN_EPS)
        self.ln_ff = LayerNorm(d_pair, LN_EPS)
        self.ff = FeedForward(d_pair, d_ff, p_dropout, dtype=dtype)

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        if self.attn_impl == "pallas":
            # JAX hands the LN to the attention module here, which normalizes
            # and casts back to the stream dtype before attending
            x = x + self.row_attn(layer_norm(
                x, self.ln_row.weight, self.ln_row.bias, LN_EPS).to(x.dtype))
            x = x + self.col_attn(layer_norm(
                x, self.ln_col.weight, self.ln_col.bias, LN_EPS).to(x.dtype))
        else:
            x = x + self.row_attn(self.ln_row(x))
            x = x + self.col_attn(self.ln_col(x))
        L = x.shape[1]
        if self.attn_impl == "pallas" and L >= FUSED_MIN_L:
            require_unported("fused_ff", L)
        return x + self.ff(self.ln_ff(x))


class PairUpdateWithAxialAttention(nn.Module):
    """N-layer axial attention stack."""

    def __init__(self, d_pair: int, d_ff: int, n_heads: int = 8, p_dropout: float = 0.1,
                 n_encoder_layers: int = 4, feature_seed: int = 42,
                 performer_dim_head: int = 64, attn_impl: str = "xla", dtype=None):
        super().__init__()
        self.n = n_encoder_layers
        for i in range(n_encoder_layers):
            self.add_module(f"layer_{i}", PairUpdateWithAxialAttentionLayer(
                d_pair, d_ff, n_heads, p_dropout, feature_seed=feature_seed + 2 * i,
                performer_dim_head=performer_dim_head, attn_impl=attn_impl, dtype=dtype))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"layer_{i}")(x)
        return x
