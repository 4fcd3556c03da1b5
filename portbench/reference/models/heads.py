"""Prediction head: 6D inter-residue geometry logits (port of
rosettafold_tpu/models/heads.py). theta/phi read the asymmetric pair map,
dist/omega the symmetrized one."""

from __future__ import annotations

from torch import nn

from .layers import Dense, LayerNorm
from .resnet import ResNet


class PredictionHead(nn.Module):
    """pair (B, L, L, C) -> {theta (37), phi (19), dist (37), omega (37)}.
    row_chunk: the towers' long-L inference mode (models/resnet.py)."""

    BINS = (("theta", 37), ("phi", 19), ("dist", 37), ("omega", 37))

    def __init__(self, in_channels: int, n_res_blocks: int = 4, p_dropout: float = 0.1,
                 dtype=None, conv_impl: str = "xla", row_chunk=None):
        super().__init__()
        self.proj_ln = LayerNorm(in_channels)
        self.proj = Dense(in_channels, in_channels, dtype=dtype)
        self.dropout = nn.Dropout(p_dropout)
        for name, n_bins in self.BINS:
            self.add_module(f"{name}_head", ResNet(
                n_res_blocks, in_channels, in_channels, n_bins, p_dropout=p_dropout,
                dtype=dtype, conv_impl=conv_impl, row_chunk=row_chunk))

    def forward(self, pair):
        x = self.dropout(self.proj(self.proj_ln(pair)))
        x_sym = 0.5 * (x + x.transpose(1, 2))
        return {name: getattr(self, f"{name}_head")(x if name in ("theta", "phi") else x_sym)
                for name, _ in self.BINS}
