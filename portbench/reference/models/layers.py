"""Building blocks with flax's dtype semantics.

flax's `nn.Dense(dtype=bf16)` casts inputs and parameters to bf16 and returns
bf16; `nn.Dense(dtype=None)` promotes and returns float32 when the parameters
are float32. `nn.LayerNorm` keeps float32 statistics and returns float32 for
float32 parameters, with the mean-of-squares variance (`use_fast_variance`).
These classes reproduce that, so the bf16 trunk rounds at the places the JAX
package does. Parameter names follow PyTorch (`weight`, `bias`); the bridge
maps flax's (`kernel`, `scale`) onto them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .._mesh import full, reduce_from_tp

# L from which the JAX package engages the fused pair-track kernels (C, D, E,
# F): the default of each module's crossover field
FUSED_MIN_L = 128


def torch_dtype(name: Optional[str]):
    return {None: None, "float32": None, "bfloat16": torch.bfloat16}[name]


class Dense(nn.Linear):
    """nn.Linear with flax Dense's compute-dtype rule (see module docstring).

    Under a tensor-parallel mesh (parallel/mesh.py) its weight and bias may
    be this rank's shards: `forward` gathers them (the unsharded layer),
    `local` computes this rank's output units from its column shard, and
    `row_parallel` multiplies this rank's input units by its row shard and
    all-reduces the partial sums over tp before adding the bias once."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def _linear(self, x, w, b):
        if self.compute_dtype is not None:
            dt = self.compute_dtype
            return F.linear(x.to(dt), w.to(dt), None if b is None else b.to(dt))
        return F.linear(x.float(), w, b)

    def forward(self, x):
        return self._linear(x, full(self.weight), full(self.bias))

    def local(self, x):
        return self._linear(x, self.weight, self.bias)

    def row_parallel(self, x):
        y = reduce_from_tp(self._linear(x, self.weight, None).float())
        if self.bias is not None:
            y = y + self.bias.float()
        return y if self.compute_dtype is None else y.to(self.compute_dtype)


class LayerNorm(nn.Module):
    """flax LayerNorm: float32 statistics, var = E[x^2] - E[x]^2, float32 out."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


def layer_norm(x, weight, bias, eps):
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (x - mu) * torch.rsqrt(var + eps) * weight + bias


class ConvNHWC(nn.Conv2d):
    """flax nn.Conv on NHWC tensors (SAME padding, optional dilation), with
    flax's compute-dtype rule."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1,
                 bias: bool = False, dtype=None):
        super().__init__(cin, cout, k, padding=dilation * (k // 2),
                         dilation=dilation, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype or torch.float32
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), b,
                     padding=self.padding, dilation=self.dilation)
        return y.permute(0, 2, 3, 1)
