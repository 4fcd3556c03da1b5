"""Model configuration (the port's copy of rosettafold_tpu/config.py).

Same fields and defaults as the JAX package's dataclasses, which
tests/test_torch_ops.py holds equal; the port keeps its own copy so that it
never imports the JAX package. `attn_impl="pallas"` selects the hand-written
kernel suite (here the CUDA C++ kernels under `csrc/`), "xla" plain PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PerformerConfig:
    """FAVOR+ linear-attention settings (performer-pytorch's defaults)."""

    dim_head: int = 64
    nb_features: Optional[int] = None  # default: dim_head * ceil(log(dim_head))
    feature_seed: int = 42  # seed for the (fixed) random-feature projection
    kernel_eps: float = 1e-3  # generalized-kernel stabilizer
    softmax_eps: float = 1e-4  # softmax-kernel stabilizer


@dataclasses.dataclass(frozen=True)
class RoseTTAFoldConfig:
    """Hyperparameters of the three-track RoseTTAFold network."""

    d_input: int = 21
    d_msa: int = 384
    d_pair: int = 288
    d_node: int = 64
    d_edge: int = 64
    d_state: int = 32
    n_two_track_blocks: int = 3
    n_three_track_blocks: int = 4
    n_encoder_layers: int = 4
    max_len: int = 5000
    n_neighbors: Tuple[int, ...] = (128, 128, 64, 64, 64)
    p_dropout: float = 0.1
    use_template: bool = False
    d_template: int = 64

    performer: PerformerConfig = dataclasses.field(default_factory=PerformerConfig)

    # "xla": plain ops. "pallas": the hand-written kernels.
    attn_impl: str = "xla"
    # SE(3) layout: "dense", "scatter", "bucket" or "gather"
    se3_impl: str = "dense"
    se3_bucket_capacity: Optional[int] = None
    # True: always exclude self edges from the kNN graph
    knn_exclude_self: bool = True
    # row-chunked long-sequence paths: head_chunk (every pair ResNet),
    # long_chunk (the plain axial attention and outer product)
    long_chunk: Optional[int] = None
    head_chunk: Optional[int] = None
    # training / multi-device knobs (not ported yet)
    remat: bool = False
    shard_pair: bool = False
    # the JAX package's nn.scan over blocks; here it selects the shared
    # FAVOR+ seeds that scanning implies (models/rosettafold.py)
    scan_blocks: bool = False
    # trunk compute dtype: "float32" or "bfloat16" (statistics and SE(3) f32)
    compute_dtype: str = "float32"

    def n_neighbors_for_block(self, i: int) -> int:
        return self.n_neighbors[i]


def tiny_config(**overrides) -> RoseTTAFoldConfig:
    """Test-sized config, equal to the JAX package's `tiny_config`."""
    base = dict(
        d_msa=96,
        d_pair=72,
        d_node=32,
        d_edge=32,
        d_state=16,
        n_two_track_blocks=1,
        n_three_track_blocks=2,
        n_encoder_layers=1,
        max_len=128,
        n_neighbors=(8, 8),
        p_dropout=0.1,
    )
    base.update(overrides)
    return RoseTTAFoldConfig(**base)
