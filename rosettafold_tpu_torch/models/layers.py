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

# JAX package ROADMAP.md items of the kernels this port has not written yet.
UNPORTED_KERNELS = {
    "fused_performer": "C (ops/pallas/fused_performer.py, ROADMAP queue 2 item 1)",
    "fused_ff": "D (ops/pallas/fused_ff.py, ROADMAP queue 2 item 2)",
    "outer_product": "E (ops/pallas/outer_product.py, ROADMAP queue 2 item 3)",
    "conv3x3": "F (ops/pallas/conv3x3.py, ROADMAP queue 2 item 4)",
}

# L from which the JAX package engages the fused pair-track kernels
FUSED_MIN_L = 128


def require_unported(name: str, L: int):
    """Raise where the JAX package would run a kernel this port lacks: the
    port never runs the plain math in place of a kernel."""
    raise NotImplementedError(
        f"attn_impl='pallas' at L={L} >= {FUSED_MIN_L} runs kernel "
        f"{UNPORTED_KERNELS[name]}, which is not ported to CUDA yet; "
        "use attn_impl='xla' (plain PyTorch) or L < 128")


def torch_dtype(name: Optional[str]):
    return {None: None, "float32": None, "bfloat16": torch.bfloat16}[name]


class Dense(nn.Linear):
    """nn.Linear with flax Dense's compute-dtype rule (see module docstring)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        if self.compute_dtype is not None:
            dt = self.compute_dtype
            b = None if self.bias is None else self.bias.to(dt)
            return F.linear(x.to(dt), self.weight.to(dt), b)
        return F.linear(x.float(), self.weight, self.bias)


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
