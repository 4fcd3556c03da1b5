"""rosettafold_tpu_torch — the PyTorch / CUDA port of rosettafold_tpu.

The JAX package (`rosettafold_tpu`) is the reference; this package is held
against it module by module (tests/test_torch_*.py). It imports torch and
numpy only; from the JAX package it reads just the numpy-only modules
(`rosettafold_tpu.config`, `rosettafold_tpu.data.{a3m,pdb,vocab}`).

Configuration is the shared `RoseTTAFoldConfig`. In this package
`attn_impl="pallas"` means "the hand-written kernel suite": the CUDA C++
kernels under `csrc/`, so that `predict.fast_config(L)` stays identical to the
JAX serving preset. Kernels ported so far: the tied row attention and the
dense SE(3) attend. With `attn_impl="pallas"` and L >= 128 the model raises
NotImplementedError, because the fused FAVOR+, FF, outer-product and 3x3 conv
kernels that JAX engages there are not ported yet. `attn_impl="xla"` runs
plain PyTorch at any L.
"""

from rosettafold_tpu.config import PerformerConfig, RoseTTAFoldConfig, tiny_config

__all__ = ["RoseTTAFoldConfig", "PerformerConfig", "tiny_config", "RoseTTAFold"]


def __getattr__(name):
    if name == "RoseTTAFold":
        from .models.rosettafold import RoseTTAFold

        return RoseTTAFold
    raise AttributeError(name)
