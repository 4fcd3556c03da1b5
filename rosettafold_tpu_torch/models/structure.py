"""Structure-track modules (port of rosettafold_tpu/models/structure.py; SE(3)
layouts "dense", "scatter", "bucket" and "gather"): graph transformer,
initial coordinates, SE(3) refinement."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import knn
from ..tracing import span
from .layers import Dense, LayerNorm
from .msa import PositionWiseWeightFactor
from .se3 import SE3Transformer

N_IDX, CA_IDX, C_IDX = 0, 1, 2


class GraphTransformer(nn.Module):
    """Dense graph-transformer attention with edge features in the logits and
    the values."""

    def __init__(self, d_node_in: int, d_node_out: int, d_edge: int, n_heads: int,
                 p_dropout: float = 0.15, dtype=None):
        super().__init__()
        self.h, self.dh = n_heads, d_node_out
        inner = d_node_out * n_heads
        self.node_to_q = Dense(d_node_in, inner, dtype=dtype)
        self.node_to_k = Dense(d_node_in, inner, dtype=dtype)
        self.node_to_v = Dense(d_node_in, inner, dtype=dtype)
        self.edge_emb = Dense(d_edge, inner, bias=False, dtype=dtype)
        self.node_update = Dense(d_node_in, inner, dtype=dtype)
        self.dropout = nn.Dropout(p_dropout)

    def forward(self, node, edge):
        h, dh = self.h, self.dh
        B, L, _ = node.shape
        q, k, v = (m(node).reshape(B, L, h, dh).transpose(1, 2)
                   for m in (self.node_to_q, self.node_to_k, self.node_to_v))
        e = self.edge_emb(edge).reshape(B, L, L, h, dh).permute(0, 3, 1, 2, 4)
        qf, kf, vf, ef = q.float(), k.float(), v.float(), e.float()
        logit = torch.einsum("bhid,bhjd->bhij", qf, kf)
        logit = logit + torch.einsum("bhid,bhijd->bhij", qf, ef)
        att = self.dropout(torch.softmax(logit * dh ** -0.5, dim=-1).to(v.dtype)).float()
        upd = torch.einsum("bhij,bhjd->bhid", att, vf)
        upd = upd + torch.einsum("bhij,bhijd->bhid", att, ef)
        upd = upd.transpose(1, 2).reshape(B, L, h * dh)
        return self.node_update(node).float() + upd


class GraphTransformerBlock(nn.Module):
    """attn -> LN -> Linear + ELU -> residual."""

    def __init__(self, d_node_in: int, d_node_out: int, d_edge: int, n_heads: int,
                 p_dropout: float = 0.15, dtype=None):
        super().__init__()
        self.attn = GraphTransformer(d_node_in, d_node_out, d_edge, n_heads, p_dropout,
                                     dtype=dtype)
        self.ln = LayerNorm(d_node_out * n_heads)
        self.to_out = Dense(d_node_out * n_heads, d_node_in)

    def forward(self, node, edge):
        return F.elu(self.to_out(self.ln(self.attn(node, edge)))) + node


def signed_sequence_separation(aa_idx: torch.Tensor) -> torch.Tensor:
    """sign(i - j) * log(|i - j| + 1) clamped to [0, 5.5], (B, L, L, 1)."""
    dist = (aa_idx[:, :, None] - aa_idx[:, None, :]).float()
    feat = torch.sign(dist) * torch.log(dist.abs() + 1.0)
    return torch.clamp(feat, 0.0, 5.5)[..., None]


class InitialCoordGenerationWithMsaAndPair(nn.Module):
    """Initial backbone coordinates from MSA + pair through dense
    graph-transformer blocks on the fully connected graph."""

    def __init__(self, d_msa: int, d_pair: int, d_node: int = 64, d_edge: int = 64,
                 n_heads: int = 4, n_layers: int = 4, p_dropout: float = 0.1,
                 d_input: int = 21, dtype=None):
        super().__init__()
        self.n = n_layers
        self.ln_msa = LayerNorm(d_msa)
        self.ln_pair = LayerNorm(d_pair)
        self.poswise = PositionWiseWeightFactor(d_msa, 1, p_dropout)
        self.node_embed = Dense(d_msa + d_input, d_node)
        self.edge_embed = Dense(d_pair + 1, d_edge)
        for i in range(n_layers):
            self.add_module(f"block_{i}", GraphTransformerBlock(
                d_node, d_node, d_edge, n_heads, p_dropout, dtype=dtype))
        self.to_out = Dense(d_node, 9)

    def forward(self, msa, pair, seq_onehot, aa_idx):
        msa = self.ln_msa(msa)
        pair = self.ln_pair(pair)
        w = self.poswise(msa)[:, :, 0]  # (B, N, L, 1)
        node = torch.cat([(msa * w).sum(1), seq_onehot], dim=-1)
        node = F.elu(self.node_embed(node))
        edge = torch.cat([pair, signed_sequence_separation(aa_idx)], dim=-1)
        edge = F.elu(self.edge_embed(edge))
        for i in range(self.n):
            node = getattr(self, f"block_{i}")(node, edge)
        xyz = self.to_out(node)
        return xyz.reshape(*xyz.shape[:2], 3, 3)


SE3_IMPLS = ("dense", "scatter", "bucket", "gather")


class CoordUpdateWithMsaAndPair(nn.Module):
    """SE(3)-equivariant coordinate refinement on a kNN graph: node features
    from the position-weighted MSA sum + query one-hot, edge features from the
    projected pair; the type-1 output displaces CA first, then N and C
    relative to the new CA.

    se3_impl: "dense", the exact incoming sets on an (L, L) mask; "scatter",
    the same edges as a src-major list (slot s of source i points at
    dst_idx[b, i, s], `knn_gather_indices`) aggregated at each destination by
    segment ops, with no capacity; "bucket", the same sets in C static slots
    per destination (`knn_bucket_indices`, capacity `bucket_capacity`);
    "gather", the forward-top-k approximation on (L, S) slots. The last three
    hold O(L*S) edge tensors. With k_dynamic the
    top-k is taken at n_neighbors and cut to its first k_dynamic slots (the
    scanned blocks' form). A bucket forward keeps its overflow (B,) int32 in
    `bucket_overflow` (JAX sows it as diagnostics/se3_bucket_overflow). The
    SE(3) transformer runs in the profiler span `span_name + ".se3"`;
    RoseTTAFold sets `span_name` to the module's path."""

    span_name = "rf.coord_update_with_msa_and_pair"

    def __init__(self, d_msa: int, d_pair: int, d_node: int = 64, d_edge: int = 64,
                 d_state: int = 32, n_neighbors: int = 64, p_dropout: float = 0.1,
                 knn_exclude_self: bool = True, attn_impl: str = "xla",
                 d_input: int = 21, se3_impl: str = "dense", bucket_capacity=None,
                 k_dynamic=None):
        super().__init__()
        if se3_impl not in SE3_IMPLS:
            raise ValueError(f"se3_impl={se3_impl!r}: one of {SE3_IMPLS}")
        self.n_neighbors, self.knn_exclude_self = n_neighbors, knn_exclude_self
        self.se3_impl, self.bucket_capacity, self.k_dynamic = se3_impl, bucket_capacity, k_dynamic
        self.bucket_overflow = None
        self.ln_msa = LayerNorm(d_msa)
        self.ln_pair = LayerNorm(d_pair)
        self.poswise = PositionWiseWeightFactor(d_msa, 1, p_dropout)
        self.node_embed = Dense(d_msa + d_input, d_node)
        self.node_ln = LayerNorm(d_node)
        self.edge_embed = Dense(d_pair, d_edge)
        self.edge_ln = LayerNorm(d_edge)
        self.se3 = SE3Transformer(
            num_layers=2, num_channels=16, n_heads=4, num_degrees=2,
            l0_in_features=d_node, l1_in_features=3, l0_out_features=d_state,
            l1_out_features=3, num_edge_features=d_edge, impl=attn_impl)

    def forward(self, xyz, msa, pair, aa_idx, seq_onehot):
        msa = self.ln_msa(msa)
        pair = self.ln_pair(pair)
        w = self.poswise(msa)[:, :, 0]
        node = torch.cat([(msa * w).sum(1), seq_onehot], dim=-1)
        node = self.node_ln(F.elu(self.node_embed(node)))
        edge = self.edge_ln(F.elu(self.edge_embed(pair)))  # (B, i, j, de)

        ca = xyz[:, :, CA_IDX]
        src_idx = dst_idx = None
        if self.se3_impl == "scatter":
            # src-major: slot s of source i points at dst_idx[b, i, s]
            dst_idx, mask = knn.knn_gather_indices(xyz, aa_idx, self.n_neighbors,
                                                   k_dynamic=self.k_dynamic)
            B, L, S = dst_idx.shape
            idx = dst_idx.long()
            ca_dst = torch.gather(ca, 1, idx.reshape(B, L * S, 1).expand(-1, -1, 3))
            rel_pos = ca_dst.reshape(B, L, S, 3) - ca[:, :, None, :]  # dst - src
            # w[b, i, s] = edge[b, i, dst_idx[b, i, s]]
            edge_w = torch.gather(edge, 2, idx[..., None].expand(-1, -1, -1, edge.shape[-1]))
        elif self.se3_impl == "dense":
            cond = knn.knn_adjacency(xyz, aa_idx, self.n_neighbors,
                                     exclude_self=self.knn_exclude_self,
                                     k_dynamic=self.k_dynamic)
            mask = knn.incoming_mask(cond).contiguous()       # (B, j, i)
            rel_pos = ca[:, :, None, :] - ca[:, None, :, :]   # [b, j, i] = x_j - x_i
            edge_w = edge.transpose(1, 2).contiguous()        # w[b, j, i] = edge[b, i, j]
        else:
            if self.se3_impl == "bucket":
                src_idx, mask, self.bucket_overflow = knn.knn_bucket_indices(
                    xyz, aa_idx, self.n_neighbors, capacity=self.bucket_capacity,
                    k_dynamic=self.k_dynamic)
            else:
                src_idx, mask = knn.knn_gather_indices(xyz, aa_idx, self.n_neighbors,
                                                       k_dynamic=self.k_dynamic)
            B, L, S = src_idx.shape
            idx = src_idx.long()
            ca_src = torch.gather(ca, 1, idx.reshape(B, L * S, 1).expand(-1, -1, 3))
            rel_pos = ca[:, :, None, :] - ca_src.reshape(B, L, S, 3)
            # w[b, j, s] = edge[b, src_idx[b, j, s], j]: along axis 2 of edge^T
            edge_w = torch.gather(edge.transpose(1, 2), 2,
                                  idx[..., None].expand(-1, -1, -1, edge.shape[-1]))

        h0 = node[..., None]
        h1 = xyz - ca[:, :, None, :]
        with span(self.span_name + ".se3"):
            out = self.se3(h0, h1, edge_w, rel_pos, mask, src_idx, dst_idx)
        state = out[0][..., 0]
        disp = out[1]
        ca_new = ca + disp[:, :, CA_IDX]
        n_new = ca_new + disp[:, :, N_IDX]
        c_new = ca_new + disp[:, :, C_IDX]
        return state, torch.stack([n_new, ca_new, c_new], dim=2)
