"""The three-track RoseTTAFold model (port of rosettafold_tpu/models/rosettafold.py).

Contract: model(msa, seq, aa_idx) -> (logits{theta,phi,omega,dist}, xyz, plddt)
with msa (B, N, L) int, seq (B, L), aa_idx (B, L); logits[*] (B, L, L, bins),
xyz (B, L, 3, 3), plddt (B, L); float32 outputs whatever the compute dtype.

Blocks run in a Python loop. Submodule names follow the unscanned flax tree
(`two_track_{i}`, `three_track_{i}`, `final_block`, ...), so a scanned JAX
checkpoint loads through `bridge.state_dict_from_flax`, which unstacks it.
What scanning changes in JAX besides the parameter layout is reproduced here:
with `cfg.scan_blocks` every two-track block uses FAVOR+ seed 42, every
three-track block 1042 and the final block 9042 (+100 for the axial stack);
unscanned, block i uses 42 + 1000 * i. Each three-track block uses its own
static `n_neighbors[i]`, which equals the JAX scanned top-k mask.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .embeddings import MsaEmbedding, PairEmbedding
from .heads import PredictionHead
from .layers import FUSED_MIN_L, UNPORTED_KERNELS, ConvNHWC, Dense, torch_dtype
from .msa import MsaUpdateUsingSelfAttention, MsaUpdateWithPair, MsaUpdateWithPairAndCoord
from .pair import PairUpdateWithAxialAttention, PairUpdateWithMsa
from .structure import CoordUpdateWithMsaAndPair, InitialCoordGenerationWithMsaAndPair


class TwoTrackBlock(nn.Module):
    """MSA self-att -> pair-from-MSA -> pair axial att -> MSA-from-pair."""

    def __init__(self, d_msa: int, d_pair: int, n_encoder_layers: int,
                 p_dropout: float = 0.1, feature_seed: int = 42,
                 performer_dim_head: int = 64, attn_impl: str = "xla", dtype=None):
        super().__init__()
        self.msa_update_using_self_att = MsaUpdateUsingSelfAttention(
            d_msa, d_msa * 4, n_heads=12, p_dropout=p_dropout,
            n_encoder_layers=n_encoder_layers, feature_seed=feature_seed,
            performer_dim_head=performer_dim_head, attn_impl=attn_impl, dtype=dtype)
        self.pair_update_with_msa = PairUpdateWithMsa(
            d_msa, 32, d_pair, n_heads=12, p_dropout=p_dropout, attn_impl=attn_impl,
            dtype=dtype)
        self.pair_update_with_axial_attention = PairUpdateWithAxialAttention(
            d_pair, d_pair * 4, n_heads=8, p_dropout=p_dropout,
            n_encoder_layers=n_encoder_layers, feature_seed=feature_seed + 100,
            performer_dim_head=performer_dim_head, attn_impl=attn_impl, dtype=dtype)
        self.msa_update_with_pair = MsaUpdateWithPair(
            d_msa, d_pair, n_heads=4, n_encoder_layers=n_encoder_layers,
            p_dropout=p_dropout, dtype=dtype)

    def forward(self, msa, pair):
        msa, att = self.msa_update_using_self_att(msa)
        pair = self.pair_update_with_msa(msa, pair, att)
        pair = self.pair_update_with_axial_attention(pair)
        msa = self.msa_update_with_pair(msa, pair)
        return msa, pair


class ThreeTrackBlock(nn.Module):
    """Two-track ops + SE(3) coordinate update (+ structure -> MSA feedback,
    unless `final`, which adds the plDDT head instead)."""

    def __init__(self, cfg, n_neighbors: int, feature_seed: int, dtype=None,
                 final: bool = False):
        super().__init__()
        self.final = final
        self.two_track = TwoTrackBlock(
            cfg.d_msa, cfg.d_pair, cfg.n_encoder_layers, cfg.p_dropout,
            feature_seed=feature_seed, performer_dim_head=cfg.performer.dim_head,
            attn_impl=cfg.attn_impl, dtype=dtype)
        self.coord_update_with_msa_and_pair = CoordUpdateWithMsaAndPair(
            cfg.d_msa, cfg.d_pair, cfg.d_node, cfg.d_edge, cfg.d_state,
            n_neighbors=n_neighbors, p_dropout=cfg.p_dropout,
            knn_exclude_self=cfg.knn_exclude_self, attn_impl=cfg.attn_impl,
            d_input=cfg.d_input)
        if final:
            self.plddt_head = Dense(cfg.d_state, 1)
        else:
            self.msa_update_with_pair_and_coord = MsaUpdateWithPairAndCoord(
                cfg.d_msa, cfg.d_state, 32, cfg.d_msa * 4, (8, 12, 16, 20),
                cfg.p_dropout, dtype=dtype)

    def forward(self, msa, pair, xyz, seq_onehot, aa_idx):
        msa, pair = self.two_track(msa, pair)
        state, xyz = self.coord_update_with_msa_and_pair(xyz, msa, pair, aa_idx, seq_onehot)
        if self.final:
            return msa, pair, xyz, self.plddt_head(state)[..., 0]
        msa = self.msa_update_with_pair_and_coord(xyz, state, msa)
        return msa, pair, xyz


def check_supported(cfg):
    """Raise for configurations whose JAX path this port does not have yet."""
    if cfg.use_template:
        raise NotImplementedError("the template input is not ported yet")
    if cfg.se3_impl != "dense":
        raise NotImplementedError(
            f"se3_impl={cfg.se3_impl!r}: only the dense SE(3) layout is ported")
    if cfg.long_chunk is not None or cfg.head_chunk is not None:
        raise NotImplementedError("the row-chunked long-L paths are not ported yet")
    if cfg.remat:
        raise NotImplementedError("rematerialization is a training feature, not ported")


class RoseTTAFold(nn.Module):
    """Top-level three-track model, inference. Build with a RoseTTAFoldConfig;
    `device` places parameters and buffers; `seed` draws a random init in the
    spirit of flax's defaults (see `init_like_flax`)."""

    def __init__(self, config, device=None, seed: int = 0, init: bool = True):
        super().__init__()
        cfg = self.config = config
        check_supported(cfg)
        dtype = torch_dtype(cfg.compute_dtype)
        self.dtype = dtype
        self.msa_emb = MsaEmbedding(cfg.d_input, cfg.d_msa, cfg.max_len, cfg.p_dropout)
        self.pair_emb = PairEmbedding(cfg.d_input, cfg.d_pair, cfg.max_len, cfg.p_dropout)
        for i in range(cfg.n_two_track_blocks):
            seed_i = 42 if cfg.scan_blocks else 42 + 1000 * i
            self.add_module(f"two_track_{i}", TwoTrackBlock(
                cfg.d_msa, cfg.d_pair, cfg.n_encoder_layers, cfg.p_dropout,
                feature_seed=seed_i, performer_dim_head=cfg.performer.dim_head,
                attn_impl=cfg.attn_impl, dtype=dtype))
        self.initial_coords = InitialCoordGenerationWithMsaAndPair(
            cfg.d_msa, cfg.d_pair, cfg.d_node, cfg.d_edge, n_heads=4, n_layers=4,
            p_dropout=cfg.p_dropout, d_input=cfg.d_input, dtype=dtype)
        self.n_tt = cfg.n_three_track_blocks - 1
        for i in range(self.n_tt):
            seed_i = 1042 if cfg.scan_blocks else 42 + 1000 * (cfg.n_two_track_blocks + i)
            self.add_module(f"three_track_{i}", ThreeTrackBlock(
                cfg, cfg.n_neighbors[i], seed_i, dtype=dtype))
        # the final block: 32 neighbors, no structure -> MSA feedback, plDDT head
        self.final_block = ThreeTrackBlock(cfg, 32, 42 + 9000, dtype=dtype, final=True)
        self.prediction_head = PredictionHead(cfg.d_pair, 4, cfg.p_dropout, dtype=dtype,
                                              conv_impl=cfg.attn_impl)
        if init:
            init_like_flax(self, torch.Generator().manual_seed(seed))
        self.eval()
        if device is not None:
            self.to(device)

    def forward(self, msa, seq, aa_idx):
        cfg = self.config
        L = msa.shape[-1]
        if cfg.attn_impl == "pallas" and L >= FUSED_MIN_L:
            raise NotImplementedError(
                f"attn_impl='pallas' at L={L} >= {FUSED_MIN_L} runs kernels "
                + "; ".join(UNPORTED_KERNELS.values())
                + ", which are not ported to CUDA yet; use attn_impl='xla' or L < 128")
        x = self.msa_emb(msa, aa_idx)
        pair = self.pair_emb(seq, aa_idx)
        seq_onehot = F.one_hot(seq.long(), cfg.d_input).to(x.dtype)
        if self.dtype is not None:
            pair = pair.to(self.dtype)  # bf16 pair stream between blocks
        for i in range(cfg.n_two_track_blocks):
            x, pair = getattr(self, f"two_track_{i}")(x, pair)
        xyz = self.initial_coords(x, pair, seq_onehot, aa_idx)
        for i in range(self.n_tt):
            x, pair, xyz = getattr(self, f"three_track_{i}")(x, pair, xyz, seq_onehot, aa_idx)
        x, pair, xyz, plddt = self.final_block(x, pair, xyz, seq_onehot, aa_idx)
        logits = self.prediction_head(pair)
        return ({k: v.float() for k, v in logits.items()}, xyz.float(), plddt.float())


def _trunc_normal(shape, std, g):
    # flax's truncated_normal(-2, 2) rescaled to unit variance
    return torch.randn(shape, generator=g).clamp_(-2.0, 2.0) * (std / 0.87962566103423978)


@torch.no_grad()
def init_like_flax(model: nn.Module, g: torch.Generator):
    """Random init drawn from `g` with the flax defaults' scales: Dense/Conv
    kernels lecun-normal (he-uniform where the JAX module asks for it), zero
    biases, unit norms, normal embeddings, normal(1/sqrt(m_in)) SE(3) 1x1
    weights and normal(1) norm biases. Weights differ from a JAX init of the
    same seed (the generators differ); the scales agree."""
    from .se3 import G1x1SE3, GNormBias

    for mod in model.modules():
        if isinstance(mod, (Dense, ConvNHWC)):
            w = mod.weight
            fan_in = w[0].numel()
            if getattr(mod, "he_uniform", False):
                lim = math.sqrt(6.0 / fan_in)
                w.copy_(torch.rand(w.shape, generator=g) * 2 * lim - lim)
            else:
                w.copy_(_trunc_normal(w.shape, math.sqrt(1.0 / fan_in), g))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=g)
                             / math.sqrt(mod.weight.shape[1]))
        elif isinstance(mod, G1x1SE3):
            for d in mod.degrees:
                W = getattr(mod, f"W_{d}")
                W.copy_(torch.randn(W.shape, generator=g) / math.sqrt(W.shape[1]))
        elif isinstance(mod, GNormBias):
            for d in mod.fiber.degrees:
                b = getattr(mod, f"bias_{d}")
                b.copy_(torch.randn(b.shape, generator=g))
