"""The three-track RoseTTAFold model (port of rosettafold_tpu/models/rosettafold.py).

Contract: model(msa, seq, aa_idx) -> (logits{theta,phi,omega,dist}, xyz, plddt)
with msa (B, N, L) int, seq (B, L), aa_idx (B, L); logits[*] (B, L, L, bins),
xyz (B, L, 3, 3), plddt (B, L); float32 outputs whatever the compute dtype.

The model is built in eval mode (JAX's deterministic=True); `model.train()`
is JAX's deterministic=False: dropout, and the kernel dispatch JAX keys on it
(C without its folded LN/residual, no D, F's pre-op unfused). With
`cfg.remat`, while autograd records, the blocks, the initial coordinates and
the head run under `torch.utils.checkpoint` (the modules JAX remats), whose
saved RNG state gives the recomputation the forward's dropout masks.

Blocks run in a Python loop. Submodule names follow the unscanned flax tree
(`two_track_{i}`, `three_track_{i}`, `final_block`, ...), so a scanned JAX
checkpoint loads through `bridge.state_dict_from_flax`, which unstacks it.
What scanning changes in JAX besides the parameter layout is reproduced here:
with `cfg.scan_blocks` every two-track block uses FAVOR+ seed 42, every
three-track block 1042 and the final block 9042 (+100 for the axial stack);
unscanned, block i uses 42 + 1000 * i. Scanned three-track blocks take
their top-k at K_max = max(n_neighbors[:n_tt]) and cut it to their own
n_neighbors[i] (`k_dynamic`), as JAX's scanned block does: the dense mask is
the same as a top-k at n_neighbors[i], but the bucket capacity follows
K_max. Unscanned, each block takes its own n_neighbors[i]; the final block
32. `cfg.head_chunk` row-chunks every pair ResNet (each block's and the
head's), as JAX passes it on as `conv_chunk`; `cfg.long_chunk` row-chunks
each block's plain outer product and axial attention. With
`cfg.use_template` the model takes a template (B, L, L, d_template) as its
fourth input. `cfg.shard_pair` passes the pair stream through
`parallel.mesh.shard_pair_constraint` where JAX does: the identity without
sequence parallelism, which is not ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._mesh import shard_pair_constraint
from .embeddings import MsaEmbedding, PairEmbedding
from .heads import PredictionHead
from .layers import ConvNHWC, Dense, torch_dtype
from .msa import MsaUpdateUsingSelfAttention, MsaUpdateWithPair, MsaUpdateWithPairAndCoord
from .pair import PairUpdateWithAxialAttention, PairUpdateWithMsa
from .structure import CoordUpdateWithMsaAndPair, InitialCoordGenerationWithMsaAndPair


class TwoTrackBlock(nn.Module):
    """MSA self-att -> pair-from-MSA -> pair axial att -> MSA-from-pair."""

    def __init__(self, d_msa: int, d_pair: int, n_encoder_layers: int,
                 p_dropout: float = 0.1, feature_seed: int = 42,
                 performer_dim_head: int = 64, attn_impl: str = "xla", dtype=None,
                 conv_chunk=None, long_chunk=None):
        super().__init__()
        self.msa_update_using_self_att = MsaUpdateUsingSelfAttention(
            d_msa, d_msa * 4, n_heads=12, p_dropout=p_dropout,
            n_encoder_layers=n_encoder_layers, feature_seed=feature_seed,
            performer_dim_head=performer_dim_head, attn_impl=attn_impl, dtype=dtype)
        self.pair_update_with_msa = PairUpdateWithMsa(
            d_msa, 32, d_pair, n_heads=12, p_dropout=p_dropout, attn_impl=attn_impl,
            dtype=dtype, row_chunk=conv_chunk, long_chunk=long_chunk)
        self.pair_update_with_axial_attention = PairUpdateWithAxialAttention(
            d_pair, d_pair * 4, n_heads=8, p_dropout=p_dropout,
            n_encoder_layers=n_encoder_layers, feature_seed=feature_seed + 100,
            performer_dim_head=performer_dim_head, attn_impl=attn_impl, dtype=dtype,
            ff_chunk=conv_chunk, long_chunk=long_chunk)
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
                 final: bool = False, k_dynamic=None):
        super().__init__()
        self.final = final
        self.two_track = TwoTrackBlock(
            cfg.d_msa, cfg.d_pair, cfg.n_encoder_layers, cfg.p_dropout,
            feature_seed=feature_seed, performer_dim_head=cfg.performer.dim_head,
            attn_impl=cfg.attn_impl, dtype=dtype, conv_chunk=cfg.head_chunk,
            long_chunk=cfg.long_chunk)
        self.coord_update_with_msa_and_pair = CoordUpdateWithMsaAndPair(
            cfg.d_msa, cfg.d_pair, cfg.d_node, cfg.d_edge, cfg.d_state,
            n_neighbors=n_neighbors, p_dropout=cfg.p_dropout,
            knn_exclude_self=cfg.knn_exclude_self, attn_impl=cfg.attn_impl,
            d_input=cfg.d_input, se3_impl=cfg.se3_impl,
            bucket_capacity=cfg.se3_bucket_capacity, k_dynamic=k_dynamic)
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


class RoseTTAFold(nn.Module):
    """Top-level three-track model. Build with a RoseTTAFoldConfig; `device`
    places parameters and buffers; `seed` draws a random init in the spirit of
    flax's defaults (see `init_like_flax`). Built in eval mode."""

    def __init__(self, config, device=None, seed: int = 0, init: bool = True):
        super().__init__()
        cfg = self.config = config
        dtype = torch_dtype(cfg.compute_dtype)
        self.dtype = dtype
        self.msa_emb = MsaEmbedding(cfg.d_input, cfg.d_msa, cfg.max_len, cfg.p_dropout)
        self.pair_emb = PairEmbedding(cfg.d_input, cfg.d_pair, cfg.max_len, cfg.p_dropout,
                                      use_template=cfg.use_template, d_template=cfg.d_template)
        for i in range(cfg.n_two_track_blocks):
            seed_i = 42 if cfg.scan_blocks else 42 + 1000 * i
            self.add_module(f"two_track_{i}", TwoTrackBlock(
                cfg.d_msa, cfg.d_pair, cfg.n_encoder_layers, cfg.p_dropout,
                feature_seed=seed_i, performer_dim_head=cfg.performer.dim_head,
                attn_impl=cfg.attn_impl, dtype=dtype, conv_chunk=cfg.head_chunk,
                long_chunk=cfg.long_chunk))
        self.initial_coords = InitialCoordGenerationWithMsaAndPair(
            cfg.d_msa, cfg.d_pair, cfg.d_node, cfg.d_edge, n_heads=4, n_layers=4,
            p_dropout=cfg.p_dropout, d_input=cfg.d_input, dtype=dtype)
        self.n_tt = n_tt = cfg.n_three_track_blocks - 1
        k_max = max(cfg.n_neighbors[:n_tt], default=0)
        for i in range(n_tt):
            if cfg.scan_blocks:  # top-k at K_max, cut to this block's K
                seed_i, k, k_dyn = 1042, k_max, cfg.n_neighbors[i]
            else:
                seed_i, k, k_dyn = 42 + 1000 * (cfg.n_two_track_blocks + i), cfg.n_neighbors[i], None
            self.add_module(f"three_track_{i}", ThreeTrackBlock(
                cfg, k, seed_i, dtype=dtype, k_dynamic=k_dyn))
        # the final block: 32 neighbors, no structure -> MSA feedback, plDDT head
        self.final_block = ThreeTrackBlock(cfg, 32, 42 + 9000, dtype=dtype, final=True)
        self.prediction_head = PredictionHead(cfg.d_pair, 4, cfg.p_dropout, dtype=dtype,
                                              conv_impl=cfg.attn_impl, row_chunk=cfg.head_chunk)
        if init:
            init_like_flax(self, torch.Generator().manual_seed(seed))
        self.eval()
        if device is not None:
            self.to(device)

    def _run(self, module, *args):
        """module(*args), rematerialized in the backward under cfg.remat."""
        if self.config.remat and torch.is_grad_enabled():
            return checkpoint(module, *args, use_reentrant=False)
        return module(*args)

    def forward(self, msa, seq, aa_idx, template=None):
        cfg = self.config
        x = self.msa_emb(msa, aa_idx)
        pair = self.pair_emb(seq, aa_idx, template)
        seq_onehot = F.one_hot(seq.long(), cfg.d_input).to(x.dtype)
        if self.dtype is not None:
            pair = pair.to(self.dtype)  # bf16 pair stream between blocks
        shard_pair = shard_pair_constraint if cfg.shard_pair else (lambda p: p)
        pair = shard_pair(pair)
        for i in range(cfg.n_two_track_blocks):
            x, pair = self._run(getattr(self, f"two_track_{i}"), x, pair)
            pair = shard_pair(pair)
        xyz = self._run(self.initial_coords, x, pair, seq_onehot, aa_idx)
        for i in range(self.n_tt):
            x, pair, xyz = self._run(getattr(self, f"three_track_{i}"), x, pair, xyz, seq_onehot,
                                     aa_idx)
            pair = shard_pair(pair)
        x, pair, xyz, plddt = self._run(self.final_block, x, pair, xyz, seq_onehot, aa_idx)
        logits = self._run(self.prediction_head, pair)
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
