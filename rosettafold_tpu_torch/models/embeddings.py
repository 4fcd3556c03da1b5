"""MSA / pair input embeddings (port of rosettafold_tpu/models/embeddings.py)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.sinusoidal import gather_pe, sinusoidal_table
from .layers import Dense, LayerNorm


class SinusoidalPositionalEncoding(nn.Module):
    """1D PE added to the MSA embedding, dropout on the sum.
    x (B, N, L, dim), aa_idx (B, L) -> (B, N, L, dim)."""

    def __init__(self, dim: int, max_len: int, p_dropout: float = 0.1):
        super().__init__()
        self.register_buffer("table", sinusoidal_table(max_len, dim), persistent=False)
        self.dropout = nn.Dropout(p_dropout)

    def forward(self, x, aa_idx):
        pe = gather_pe(self.table.to(x.dtype), aa_idx)
        return self.dropout(x + pe[:, None])


class SinusoidalPositionalEncoding2D(nn.Module):
    """Pair PE: concat of row-tiled and col-tiled half-dim tables (no dropout,
    like the reference's forward)."""

    def __init__(self, dim: int, max_len: int):
        super().__init__()
        self.register_buffer("table", sinusoidal_table(max_len, dim // 2),
                             persistent=False)

    def forward(self, x, aa_idx):
        pe = gather_pe(self.table.to(x.dtype), aa_idx)  # (B, L, dim/2)
        B, L, h = pe.shape
        pe_i = pe[:, :, None, :].expand(B, L, L, h)
        pe_j = pe[:, None, :, :].expand(B, L, L, h)
        return x + torch.cat([pe_i, pe_j], dim=-1)


class MsaEmbedding(nn.Module):
    """Token + positional + query-segment embedding: msa (B, N, L) -> (B, N, L, d)."""

    def __init__(self, d_input: int = 21, d_msa: int = 384, max_len: int = 260,
                 p_pe_drop: float = 0.1):
        super().__init__()
        self.to_embedding = nn.Embedding(d_input, d_msa)
        self.pos_enc = SinusoidalPositionalEncoding(d_msa, max_len, p_pe_drop)
        self.query_enc = nn.Embedding(2, d_msa)

    def forward(self, msa, aa_idx):
        n_seq = msa.shape[-2]
        x = self.pos_enc(self.to_embedding(msa.long()), aa_idx)
        query_idx = torch.ones(n_seq, dtype=torch.long, device=msa.device)
        query_idx[0] = 0
        return x + self.query_enc(query_idx)[None, :, None, :]


class PairEmbedding(nn.Module):
    """Initial pair representation: seq (B, L), aa_idx (B, L) and, with
    use_template, template (B, L, L, d_template) -> (B, L, L, d_pair). The
    features (row- and column-tiled residue embeddings, the log sequence
    separation and the LayerNormed template) are projected to d_pair and the
    2D positional encoding is added."""

    def __init__(self, d_input: int = 21, d_pair: int = 288, max_len: int = 260,
                 p_pe_drop: float = 0.1, use_template: bool = False, d_template: int = 64):
        super().__init__()
        self.use_template = use_template
        half = d_pair // 2
        self.embed_seq = nn.Embedding(d_input, half)
        if use_template:
            self.ln_template = LayerNorm(d_template, 1e-5)
        self.proj = Dense(2 * half + 1 + (d_template if use_template else 0), d_pair)
        self.pos_enc = SinusoidalPositionalEncoding2D(d_pair, max_len)

    def forward(self, seq, aa_idx, template=None):
        if not self.use_template and template is not None:
            raise ValueError("[PairEmbedding]: template is not None but use_template is False")
        L = seq.shape[-1]
        emb = self.embed_seq(seq.long())
        B, _, half = emb.shape
        left = emb[:, None, :, :].expand(B, L, L, half)
        right = emb[:, :, None, :].expand(B, L, L, half)
        dist = aa_idx[:, :, None] - aa_idx[:, None, :]
        feats = [left, right, torch.log(dist.abs().float() + 1.0)[..., None]]
        if self.use_template:
            if template is None:
                raise ValueError("[PairEmbedding]: use_template=True requires template")
            feats.append(self.ln_template(template))
        x = self.proj(torch.cat(feats, dim=-1))
        return self.pos_enc(x, aa_idx)
