"""Pair-track modules (port of rosettafold_tpu/models/pair.py).

With attn_impl="pallas" the JAX package runs the fused outer-product (E),
3x3 conv (F), FAVOR+ (C) and FF (D) kernels from L >= 128, and so does this
port, through the CUDA kernels of ops/cuda/. Each module's crossover field
(`fused_min_l`, `conv_fused_min_l`, `fused_favor_min_l`, `ff_fused_min_l`,
default 128 as in JAX) moves that point; below it both run plain math.
`row_chunk` (the conv block) and `ff_chunk` (the plain FF step) are the
long-L inference modes of JAX's `conv_chunk`: the same results over row
chunks (models/resnet.py). `long_chunk` row-chunks the plain outer product
(`chunk_size`) and the plain axial attention (`chunk_rows`); kernels E and C
hold no such intermediates and ignore it, as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.fused_ff import fused_ln_ff_residual
from ..ops.cuda.outer_product import fused_outer_product_mean
from ..parallel import mesh
from .attention import FeedForward, PerformerSelfAttention
from .layers import FUSED_MIN_L, ConvNHWC, Dense, LayerNorm
from .msa import PositionWiseWeightFactor
from .resnet import InstanceNorm2d, chunks, conv_block_kernels, conv_block_rows

LN_EPS = 1e-5


def symmetrize(x: torch.Tensor) -> torch.Tensor:
    """0.5 * (x + x^T) over the pair axes."""
    return 0.5 * (x + x.transpose(1, 2))


class OuterProductMean(nn.Module):
    """Outer-product sum over MSA rows -> pair features, then LN + Linear.
    `chunk_size` computes the plain path over chunks of rows i, so the
    (B, L, L, u*u) outer product never materializes whole."""

    def __init__(self, in_features: int, out_features: int, impl: str = "xla",
                 fused_min_l: int = FUSED_MIN_L, dtype=None, chunk_size=None):
        super().__init__()
        self.in_features, self.impl, self.dtype = in_features, impl, dtype
        self.fused_min_l, self.chunk_size = fused_min_l, chunk_size
        self.ln = LayerNorm(in_features ** 2, LN_EPS)
        self.to_out = Dense(in_features ** 2, out_features, dtype=dtype)

    def forward(self, x, y=None):
        y = x if y is None else y
        if self.dtype is not None:
            x, y = x.to(self.dtype), y.to(self.dtype)
        if self.impl == "pallas" and x.shape[2] >= self.fused_min_l:
            # kernel E: the (B, L, L, u*u) outer product never materializes
            return fused_outer_product_mean(
                x.float(), y, self.ln.weight, self.ln.bias,
                mesh.full(self.to_out.weight).t().to(x.dtype), self.to_out.bias.float(), LN_EPS,
                self.dtype or torch.float32)

        def block(x_rows):
            op = torch.einsum("bniu,bnjv->bijuv", x_rows, y)
            return self.to_out(self.ln(op.reshape(*op.shape[:3], self.in_features ** 2)))

        ranges = chunks(x.shape[2], self.chunk_size)
        if len(ranges) == 1:
            return block(x)
        return torch.cat([block(x[:, :, lo:hi]) for lo, hi in ranges], dim=1)


class PairUpdateWithMsa(nn.Module):
    """MSA -> pair update: position-weighted outer product, tiled 1D MSA
    features, LN(pair) and the tied-attention map, projected by `resnet_in`
    (applied as a sum of per-part projections, as JAX does) and one 2-conv
    residual block (3x3, InstanceNorm, ELU)."""

    def __init__(self, d_msa: int, d_proj: int = 32, d_pair: int = 288, n_heads: int = 12,
                 p_dropout: float = 0.1, attn_impl: str = "xla",
                 conv_fused_min_l: int = FUSED_MIN_L, dtype=None, row_chunk=None,
                 long_chunk=None):
        super().__init__()
        self.d_pair, self.attn_impl, self.dtype = d_pair, attn_impl, dtype
        self.row_chunk = row_chunk
        self.conv_fused_min_l = conv_fused_min_l
        self.proj_msa_ln_in = LayerNorm(d_msa, LN_EPS)
        self.proj_msa = Dense(d_msa, d_proj)
        self.proj_msa_ln_out = LayerNorm(d_proj, LN_EPS)
        self.poswise_weight = PositionWiseWeightFactor(d_proj, 1, p_dropout)
        self.outer_product_mean = OuterProductMean(d_proj, d_pair, impl=attn_impl, dtype=dtype,
                                                   chunk_size=long_chunk)
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

        def x_rows(lo, hi):
            """Rows [lo, hi) of the decomposed resnet_in output."""
            return (self.ln_coevol_feat(coevol[:, lo:hi]).to(ct) @ w_coevol
                    + self.ln_pair(pair[:, lo:hi]).to(ct) @ w_pair
                    + att[:, lo:hi].to(ct) @ w_att
                    + row_proj[:, lo:hi, None, :]
                    + col_proj[:, None, :, :]
                    + self.resnet_in.bias.to(ct))

        kernels = self.attn_impl == "pallas" and L >= self.conv_fused_min_l
        ranges = chunks(L, self.row_chunk)
        if len(ranges) > 1 and (kernels or not self.training):
            # built chunk by chunk: the float32 LN temporaries stay O(chunk)
            x = torch.empty((pair.shape[0], L, L, self.d_pair), dtype=ct, device=pair.device)
            for lo, hi in ranges:
                x[:, lo:hi] = x_rows(lo, hi)
            if not kernels:
                return conv_block_rows(self, x, 1, self.row_chunk)
        else:
            x = x_rows(0, L)
        if kernels:
            return conv_block_kernels(self, x, 1, self.row_chunk)
        y = F.elu(self.in1(self.conv1(x)))
        y = self.in2(self.conv2(self.dropout(y)))
        out = F.elu(x.float() + y)
        return out if self.dtype is None else out.to(self.dtype)


class PairUpdateWithAxialAttentionLayer(nn.Module):
    """Axial FAVOR+ (generalized ReLU kernel) over the pair map: row step
    (attend over axis 1), column step (axis 2), each a pre-LN residual, then a
    pre-LN FF residual. With attn_impl="pallas" the attention steps take the
    LN parameters (kernel C folds LN and residual in from `fused_favor_min_l`)
    and the FF step runs as kernel D from `ff_fused_min_l`, when dropout is
    inactive."""

    def __init__(self, d_pair: int, d_ff: int, n_heads: int = 8, p_dropout: float = 0.1,
                 feature_seed: int = 42, performer_dim_head: int = 64,
                 attn_impl: str = "xla", fused_favor_min_l=None,
                 ff_fused_min_l: int = FUSED_MIN_L, dtype=None, ff_chunk=None,
                 long_chunk=None):
        super().__init__()
        self.attn_impl, self.dtype, self.ff_chunk = attn_impl, dtype, ff_chunk
        self.ff_fused_min_l, self.p_dropout = ff_fused_min_l, p_dropout
        kw = dict(dim=d_pair, heads=n_heads, dim_head=performer_dim_head,
                  p_dropout=p_dropout, generalized_attention=True,
                  attn_impl=attn_impl, fused_favor_min_l=fused_favor_min_l, dtype=dtype,
                  chunk_rows=long_chunk)
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
            # as JAX: the attention module normalizes (in the kernel or
            # before attending) and adds the residual itself
            x = self.row_attn(x, ln_params=(self.ln_row.weight, self.ln_row.bias, LN_EPS))
            x = self.col_attn(x, ln_params=(self.ln_col.weight, self.ln_col.bias, LN_EPS))
        else:
            x = x + self.row_attn(self.ln_row(x))
            x = x + self.col_attn(self.ln_col(x))
        if (self.attn_impl == "pallas" and x.shape[1] >= self.ff_fused_min_l
                and (not self.training or self.p_dropout == 0.0)):
            cdt = self.dtype or x.dtype
            ff = self.ff
            return fused_ln_ff_residual(
                x.contiguous(), self.ln_ff.weight.float(), self.ln_ff.bias.float(),
                mesh.full(ff.fc1.weight).t().to(cdt), mesh.full(ff.fc1.bias).float(),
                mesh.full(ff.fc2.weight).t().to(cdt), ff.fc2.bias.float(), LN_EPS)
        ranges = chunks(x.shape[1], self.ff_chunk)
        if len(ranges) > 1 and not self.training:  # pointwise: exact, no halo
            out = torch.empty_like(x)
            for lo, hi in ranges:
                xs = x[:, lo:hi]
                out[:, lo:hi] = xs + self.ff(self.ln_ff(xs))
            return out
        return x + self.ff(self.ln_ff(x))


class PairUpdateWithAxialAttention(nn.Module):
    """N-layer axial attention stack."""

    def __init__(self, d_pair: int, d_ff: int, n_heads: int = 8, p_dropout: float = 0.1,
                 n_encoder_layers: int = 4, feature_seed: int = 42,
                 performer_dim_head: int = 64, attn_impl: str = "xla",
                 fused_favor_min_l=None, ff_fused_min_l: int = FUSED_MIN_L, dtype=None,
                 ff_chunk=None, long_chunk=None):
        super().__init__()
        self.n = n_encoder_layers
        for i in range(n_encoder_layers):
            self.add_module(f"layer_{i}", PairUpdateWithAxialAttentionLayer(
                d_pair, d_ff, n_heads, p_dropout, feature_seed=feature_seed + 2 * i,
                performer_dim_head=performer_dim_head, attn_impl=attn_impl,
                fused_favor_min_l=fused_favor_min_l, ff_fused_min_l=ff_fused_min_l,
                dtype=dtype, ff_chunk=ff_chunk, long_chunk=long_chunk))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"layer_{i}")(x)
        return x
