"""MSA-track modules (port of rosettafold_tpu/models/msa.py)."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .._nokernels import tied_flash_attention
from .. import _mesh as mesh
from .attention import FeedForward, PerformerSelfAttention
from .layers import Dense, LayerNorm


class PositionWiseWeightFactor(nn.Module):
    """Soft weight of each MSA row against the query, per position and head:
    msa (B, N, L, d) -> (B, N, h, L, 1), softmax over N, dropout after it.
    local=True (under tp, from the tied attention): this rank's heads, from
    the column shards of to_q and to_k."""

    def __init__(self, d_msa: int, n_heads: int = 12, p_dropout: float = 0.1, dtype=None):
        super().__init__()
        assert d_msa % n_heads == 0, (
            f"[PositionWiseWeightFactor]: d_msa ({d_msa}) must be divisible by "
            f"n_heads ({n_heads}).")
        self.n_heads = n_heads
        self.d_head = d_msa // n_heads
        self.to_q = Dense(d_msa, d_msa, dtype=dtype)
        self.to_k = Dense(d_msa, d_msa, dtype=dtype)
        self.dropout = nn.Dropout(p_dropout)

    def forward(self, msa, local: bool = False):
        q = self.to_q.local(msa[:, 0]) if local else self.to_q(msa[:, 0])
        k = self.to_k.local(msa) if local else self.to_k(msa)
        B, L = q.shape[:2]
        q = q.reshape(B, L, -1, self.d_head) * self.d_head ** -0.5
        k = k.reshape(B, k.shape[1], L, -1, self.d_head)
        logits = torch.einsum("blhd,bnlhd->blhn", q.float(), k.float())
        att = torch.softmax(logits, dim=-1).to(q.dtype)
        att = att.permute(0, 3, 2, 1)[..., None]  # (B, N, h, L, 1)
        return mesh.tp_dropout(self.dropout, att, 2) if local else self.dropout(att)


class SoftTiedAttentionOverResidues(nn.Module):
    """Row-tied attention over residues: one L x L map shared by all N rows.
    With attn_impl="pallas" (and no map requested) the tied attention runs
    through kernel A (ops/cuda/tied_attention.py); otherwise plain PyTorch,
    optionally returning the symmetrized per-head map (B, L, L, h).

    Under a tp mesh each rank attends with its h/tp heads (to_q/k/v and the
    position-wise factor's to_q/to_k are column shards): kernel A and its
    backward run on the B*h/tp folded problems of those heads, and to_out's
    row shard sums the heads with one all-reduce."""

    def __init__(self, d_msa: int, n_heads: int = 12, p_dropout: float = 0.1,
                 return_att: bool = False, attn_impl: str = "xla", dtype=None):
        super().__init__()
        assert d_msa % n_heads == 0
        self.h, self.d_head = n_heads, d_msa // n_heads
        self.return_att, self.attn_impl = return_att, attn_impl
        self.to_q = Dense(d_msa, d_msa, dtype=dtype)
        self.to_k = Dense(d_msa, d_msa, dtype=dtype)
        self.to_v = Dense(d_msa, d_msa, dtype=dtype)
        self.poswise_weight = PositionWiseWeightFactor(d_msa, n_heads, p_dropout, dtype=dtype)
        self.to_out = Dense(d_msa, d_msa, dtype=dtype)
        self.dropout = nn.Dropout(p_dropout)

    def forward(self, x):
        pw = self.poswise_weight
        local = mesh.is_local(self.to_q.weight, self.to_k.weight, self.to_v.weight,
                              self.to_out.weight, pw.to_q.weight, pw.to_k.weight
                              ) and self.h % mesh.tp_size() == 0
        h, dh = self.h // mesh.tp_size() if local else self.h, self.d_head
        B, N, L, _ = x.shape
        D = h * dh
        if local:
            x = mesh.copy_to_tp(x)
        q, k, v = ((lin.local(x) if local else lin(x)).reshape(B, N, L, h, dh)
                   for lin in (self.to_q, self.to_k, self.to_v))
        w = pw(x, local=local)  # (B, N, h, L, 1)
        q = q * w.permute(0, 1, 3, 2, 4) * dh ** -0.5

        if self.attn_impl == "pallas" and not self.return_att:
            def fold(t):  # (B, N, L, h, d) -> (B*h, L, N*d)
                return t.permute(0, 3, 2, 1, 4).reshape(B * h, L, N * dh)

            out = tied_flash_attention(fold(q), fold(k), fold(v))
            out = out.reshape(B, h, L, N, dh).permute(0, 3, 2, 1, 4).reshape(B, N, L, D)
            att = None
        else:
            logits = torch.einsum("bnihd,bnjhd->bhij", q.float(), k.float())
            att = torch.softmax(logits, dim=-1)
            out = torch.einsum("bhij,bnjhd->bnihd", att.to(v.dtype).float(), v.float())
            out = out.to(v.dtype).reshape(B, N, L, D)

        out = self.dropout(self.to_out.row_parallel(out) if local else self.to_out(out))
        if self.return_att:
            att_sym = (0.5 * (att + att.transpose(-1, -2))).permute(0, 2, 3, 1)  # (B, i, j, h)
            return out, mesh.gather_tp(att_sym, -1) if local else att_sym
        return out


class EncoderLayer(nn.Module):
    """Pre-LN transformer layer with tied attention or Performer attention."""

    def __init__(self, d_msa: int, d_ff: int, n_heads: int = 12, p_dropout: float = 0.1,
                 tied: bool = False, performer: bool = False, return_att: bool = False,
                 generalized_attention: bool = False, feature_seed: int = 42,
                 performer_dim_head: int = 64, attn_impl: str = "xla", dtype=None):
        super().__init__()
        self.return_att = return_att
        if tied:
            self.attn = SoftTiedAttentionOverResidues(
                d_msa, n_heads, p_dropout, return_att=return_att,
                attn_impl=attn_impl, dtype=dtype)
        elif performer:
            if return_att:
                raise NotImplementedError(
                    "PerformerSelfAttention does not support return_att.")
            self.attn = PerformerSelfAttention(
                dim=d_msa, heads=n_heads, dim_head=performer_dim_head,
                p_dropout=p_dropout, generalized_attention=generalized_attention,
                feature_seed=feature_seed, attn_impl=attn_impl, dtype=dtype)
        else:
            raise NotImplementedError
        self.ln = LayerNorm(d_msa)
        self.ff_ln = LayerNorm(d_msa)
        self.ff = FeedForward(d_msa, d_ff, p_dropout, dtype=dtype)
        self.dropout = nn.Dropout(p_dropout)

    def forward(self, x):
        orig = x
        y = self.ln(x)
        att = None
        if self.return_att:
            y, att = self.attn(y)
        else:
            y = self.attn(y)
        x = orig + self.dropout(y)
        x = x + self.dropout(self.ff(self.ff_ln(x)))
        return (x, att) if self.return_att else x


class MsaUpdateUsingSelfAttention(nn.Module):
    """Tied row-attention stack, then Performer column-attention stack.
    Returns the MSA and the symmetrized map of the LAST tied layer."""

    def __init__(self, d_msa: int, d_ff: int, n_heads: int = 12, p_dropout: float = 0.1,
                 n_encoder_layers: int = 4, feature_seed: int = 42,
                 performer_dim_head: int = 64, attn_impl: str = "xla", dtype=None):
        super().__init__()
        self.n = n_encoder_layers
        for i in range(n_encoder_layers):
            self.add_module(f"residue_wise_{i}", EncoderLayer(
                d_msa, d_ff, n_heads, p_dropout, tied=True,
                return_att=i == n_encoder_layers - 1, attn_impl=attn_impl, dtype=dtype))
        for i in range(n_encoder_layers):
            self.add_module(f"sequence_wise_{i}", EncoderLayer(
                d_msa, d_ff, n_heads, p_dropout, performer=True,
                feature_seed=feature_seed + i, performer_dim_head=performer_dim_head,
                dtype=dtype))

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        att = None
        for i in range(self.n):
            layer = getattr(self, f"residue_wise_{i}")
            if i == self.n - 1:
                x, att = layer(x)
            else:
                x = layer(x)
        x = x.transpose(1, 2)  # (B, L, N, d): attend over N
        for i in range(self.n):
            x = getattr(self, f"sequence_wise_{i}")(x)
        return x.transpose(1, 2), att


class MsaUpdateWithPairLayer(nn.Module):
    """Pair-biased MSA update: the symmetrized pair map projects to per-head
    attention, applied to every MSA row."""

    def __init__(self, d_msa: int, d_pair: int, n_heads: int = 4, p_dropout: float = 0.1,
                 dtype=None):
        super().__init__()
        self.h, self.d_msa = n_heads, d_msa
        self.pair_ln = LayerNorm(d_pair)
        self.pair2att = Dense(d_pair, n_heads)
        self.msa_ln = LayerNorm(d_msa)
        self.msa2value = Dense(d_msa, d_msa, dtype=dtype)
        self.ff_ln = LayerNorm(d_msa)
        self.ff = FeedForward(d_msa, d_msa, p_dropout, dtype=dtype)
        self.dropout = nn.Dropout(p_dropout)

    def forward(self, msa, pair):
        h = self.h
        B, N, L, _ = msa.shape
        p = 0.5 * (pair + pair.transpose(1, 2))
        logits = self.dropout(self.pair2att(self.pair_ln(p)))
        att = torch.softmax(logits.permute(0, 3, 1, 2), dim=-1)  # (B, h, i, j)
        v = self.msa2value(self.msa_ln(msa)).reshape(B, N, L, h, self.d_msa // h)
        upd = torch.einsum("bhij,bnjhd->bnihd", att.to(v.dtype).float(), v.float())
        upd = self.dropout(upd.to(v.dtype).reshape(B, N, L, self.d_msa))
        x = msa + upd
        return x + self.dropout(self.ff(self.ff_ln(x)))


class MsaUpdateWithPair(nn.Module):
    """N-layer stack of MsaUpdateWithPairLayer."""

    def __init__(self, d_msa: int, d_pair: int, n_heads: int = 4,
                 n_encoder_layers: int = 4, p_dropout: float = 0.1, dtype=None):
        super().__init__()
        self.n = n_encoder_layers
        for i in range(n_encoder_layers):
            self.add_module(f"layer_{i}", MsaUpdateWithPairLayer(
                d_msa, d_pair, n_heads, p_dropout, dtype=dtype))

    def forward(self, msa, pair):
        for i in range(self.n):
            msa = getattr(self, f"layer_{i}")(msa, pair)
        return msa


class MsaUpdateWithPairAndCoord(nn.Module):
    """Structure -> MSA feedback: four heads, one per CA-distance bin; head h
    attends only where dist < bin_h. Q/K from the SE(3) state, V from the MSA.
    Scaled by (d_state // n_heads)^-0.5, as the reference does."""

    def __init__(self, d_msa: int, d_state: int, d_trfm_inner: int = 32,
                 d_ff: int = 384 * 4, distance_bins=(8, 12, 16, 20),
                 p_dropout: float = 0.1, dtype=None):
        super().__init__()
        self.h = len(distance_bins)
        self.register_buffer("bins", torch.tensor(distance_bins, dtype=torch.float32),
                             persistent=False)
        self.d_state, self.d_msa, self.d_inner = d_state, d_msa, d_trfm_inner
        self.ln_state = LayerNorm(d_state)
        self.ln_msa = LayerNorm(d_msa)
        self.to_q = Dense(d_state, d_trfm_inner * self.h)
        self.to_k = Dense(d_state, d_trfm_inner * self.h)
        self.to_v = Dense(d_msa, d_msa, dtype=dtype)
        self.ln_out = LayerNorm(d_msa)
        self.ff_ln = LayerNorm(d_msa)
        self.ff = FeedForward(d_msa, d_ff, p_dropout, dtype=dtype)

    def forward(self, xyz, state, msa):
        h = self.h
        scale = (self.d_state // h) ** -0.5
        B, N, L, _ = msa.shape
        state = self.ln_state(state)
        msa = self.ln_msa(msa)
        q = self.to_q(state).reshape(B, L, h, self.d_inner).transpose(1, 2) * scale
        k = self.to_k(state).reshape(B, L, h, self.d_inner).transpose(1, 2)
        v = self.to_v(msa).reshape(B, N, L, h, self.d_msa // h).permute(0, 3, 1, 2, 4)

        ca = xyz[:, :, 1]
        pdist = torch.sqrt(((ca[:, :, None, :] - ca[:, None, :, :]) ** 2).sum(-1) + 1e-12)
        mask = (pdist[:, None] < self.bins[None, :, None, None]).to(q.dtype)  # b h i j
        logits = torch.einsum("bhid,bhjd->bhij", q, k) + (1.0 - mask) * -1e9
        att = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhij,bhnjd->bhnid", att.to(v.dtype).float(), v.float()).to(v.dtype)
        out = out.permute(0, 2, 3, 1, 4).reshape(B, N, L, self.d_msa)
        msa = msa + self.ln_out(out)
        return msa + self.ff(self.ff_ln(msa))
