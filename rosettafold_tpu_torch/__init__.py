"""rosettafold_tpu_torch — the PyTorch / CUDA port of rosettafold_tpu.

The JAX package (`rosettafold_tpu`) is the reference; this package is held
against it module by module (tests/test_torch_*.py). It imports torch and
numpy only, and nothing of the JAX package: `config` and `data` are its own
copies of the numpy-only modules it needs, held equal by tests.

In this package `attn_impl="pallas"` means "the hand-written kernel suite":
the CUDA C++ kernels under `csrc/`, so that `predict.fast_config(L)` stays
identical to the JAX serving preset. All six forward kernels of the serving
path are ported: tied row attention (A), dense SE(3) attend (B), fused
LN + FAVOR+ + residual (C), fused LN + FF + residual (D), fused outer-product
mean (E) and the 3x3 conv (F). `attn_impl="xla"` runs plain PyTorch at any L.
"""

from .config import PerformerConfig, RoseTTAFoldConfig, tiny_config

__all__ = ["RoseTTAFoldConfig", "PerformerConfig", "tiny_config", "RoseTTAFold"]


def __getattr__(name):
    if name == "RoseTTAFold":
        from .models.rosettafold import RoseTTAFold

        return RoseTTAFold
    raise AttributeError(name)
