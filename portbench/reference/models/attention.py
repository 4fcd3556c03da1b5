"""FeedForward and FAVOR+ self-attention (port of
rosettafold_tpu/models/attention.py)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import performer as favor
from .. import _nokernels as fp
from .. import _mesh as mesh
from .layers import FUSED_MIN_L, Dense, layer_norm


class FeedForward(nn.Module):
    """Linear -> ReLU -> Dropout -> Linear. Under a tp mesh fc1 is
    column-parallel and fc2 row-parallel: each rank computes its block of
    the hidden units, and one all-reduce sums fc2's partial products."""

    def __init__(self, d_emb: int, d_ff: int, p_dropout: float = 0.1, dtype=None):
        super().__init__()
        self.fc1 = Dense(d_emb, d_ff, dtype=dtype)
        self.fc2 = Dense(d_ff, d_emb, dtype=dtype)
        self.dropout = nn.Dropout(p_dropout)

    def forward(self, x):
        if mesh.is_local(self.fc1.weight, self.fc2.weight):
            h = torch.relu(self.fc1.local(mesh.copy_to_tp(x)))
            return self.fc2.row_parallel(mesh.tp_dropout(self.dropout, h, -1))
        return self.fc2(self.dropout(torch.relu(self.fc1(x))))


class PerformerSelfAttention(nn.Module):
    """FAVOR+ self-attention over the second-to-last axis (or axis 1 of a 4D
    (B, L1, L2, D) input with attend_axis=1): q/k/v projections to
    heads*dim_head, a fixed random-feature projection (a registered buffer
    built from `feature_seed`), output projection, dropout on the output.

    With attn_impl="pallas", the generalized (ReLU) mode and an attended
    length of at least `fused_favor_min_l` (default 128, as JAX), the layer
    runs as kernel C (ops/cuda/fused_performer.py). Both axes are read in
    place through strides; JAX takes the strided read only when L1 % 128 == 0
    and L1 <= 256 and otherwise transposes, which is the same math.

    forward(x, ln_params=(weight, bias, eps)) computes the whole pre-LN
    residual step x + dropout(attn(LN(x))); on the kernel path, with dropout
    inactive, the LN and the residual fold into the kernel.

    `chunk_rows` (the long-L mode of JAX's `long_chunk`) runs the plain path
    over chunks of at most that many rows (axis -3, after the axis-1
    transpose), which bounds the (rows, h, L, m) feature maps; the kernel path
    holds none and ignores it, as in JAX.

    Under a tp mesh (parallel/mesh.py) the plain path is Megatron's: each
    rank attends with its heads (to_q/k/v column shards) and to_out's row
    shard sums the heads with one all-reduce. The kernel path gathers the
    whole-layer weights and splits the row problems over tp
    (`tp_shard_map`), as JAX does; the axis-1 launch, which reads its
    problems in place for every L, runs whole on each rank."""

    def __init__(self, dim: int, heads: int, dim_head: int = 64,
                 nb_features: Optional[int] = None,
                 generalized_attention: bool = False, p_dropout: float = 0.0,
                 feature_seed: int = 42, kernel_eps: float = 1e-3,
                 softmax_eps: float = 1e-4, attn_impl: str = "xla",
                 fused_favor_min_l: Optional[int] = None,
                 attend_axis: int = -2, dtype=None, chunk_rows: Optional[int] = None):
        super().__init__()
        self.chunk_rows = chunk_rows
        assert attend_axis in (-2, 1)
        self.heads, self.dim_head = heads, dim_head
        self.generalized = generalized_attention
        self.kernel_eps, self.softmax_eps = kernel_eps, softmax_eps
        self.attn_impl, self.attend_axis = attn_impl, attend_axis
        self.fused_favor_min_l = FUSED_MIN_L if fused_favor_min_l is None else fused_favor_min_l
        self.p_dropout, self.dtype = p_dropout, dtype
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
        t = t.reshape(*t.shape[:-1], -1, self.dim_head)
        return t.movedim(-2, -3)

    def forward(self, x, ln_params=None):
        if self.attend_axis == 1:
            assert x.ndim == 4
        attended = x.shape[1] if self.attend_axis == 1 else x.shape[-2]
        use_fused = (self.attn_impl == "pallas" and self.generalized
                     and attended >= self.fused_favor_min_l)
        if use_fused and ln_params is not None and (
                not self.training or self.p_dropout == 0.0):
            return self._fused(x, ln_params)
        residual = None
        if ln_params is not None:
            residual = x
            x = layer_norm(x, *ln_params).to(x.dtype)
        out = self.dropout(self._fused(x, None) if use_fused else self._plain(x))
        return out if residual is None else residual + out

    def _fused(self, x, ln_params):
        """Kernel C: x + attn(LN(x)) with ln_params, attn(x) without."""
        cdt = self.dtype or x.dtype
        x = x.to(cdt).contiguous()
        w = [mesh.full(lin.weight).t().to(cdt)
             for lin in (self.to_q, self.to_k, self.to_v, self.to_out)]
        w += [self.to_out.bias.to(cdt), self.projection]
        statics = (self.dim_head ** -0.25, self.kernel_eps, self.heads, self.dim_head)
        if self.attend_axis == 1:
            if ln_params is None:
                return fp.fused_performer_layer_axis1(x, *w, *statics)
            g, b, eps = ln_params
            return fp.fused_ln_performer_residual_axis1(x, g.float(), b.float(), *w, *statics,
                                                        eps)
        x3 = x.reshape(-1, *x.shape[-2:])
        # under tp: the row problems split over the group, the weights replicated
        if ln_params is None:
            out = mesh.tp_shard_map(lambda x_, *w_: fp.fused_performer_layer(x_, *w_, *statics),
                                    x3, *w, shard=(0,))
        else:
            g, b, eps = ln_params
            out = mesh.tp_shard_map(
                lambda x_, *w_: fp.fused_ln_performer_residual(x_, *w_, *statics, eps),
                x3, g.float(), b.float(), *w, shard=(0,))
        return out.reshape(x.shape)

    def _plain(self, x):
        if self.attend_axis == 1:
            x = x.transpose(1, 2)
        c = self.chunk_rows
        if c is not None and x.ndim >= 3 and x.shape[-3] > c:
            out = torch.cat([self._attend(x[..., i:i + c, :, :])
                             for i in range(0, x.shape[-3], c)], dim=-3)
        else:
            out = self._attend(x)
        if self.attend_axis == 1:
            out = out.transpose(1, 2)
        return out

    def _attend(self, x):
        lins = (self.to_q, self.to_k, self.to_v, self.to_out)
        local = (mesh.is_local(*(lin.weight for lin in lins))
                 and self.heads % mesh.tp_size() == 0)
        if local:  # this rank's heads
            x = mesh.copy_to_tp(x)
        q, k, v = (self._split_heads(lin.local(x) if local else lin(x)) for lin in lins[:3])
        out = favor.favor_attention(
            q, k, v, self.projection, generalized=self.generalized,
            kernel_eps=self.kernel_eps, softmax_eps=self.softmax_eps)
        out = out.movedim(-3, -2)
        out = out.reshape(*out.shape[:-2], -1)
        return self.to_out.row_parallel(out) if local else self.to_out(out)
