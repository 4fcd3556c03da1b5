"""2D dilated-conv ResNet on NHWC tensors (port of rosettafold_tpu/models/resnet.py,
unchunked). InstanceNorm: eps 1e-6, biased variance, float32 statistics.
With conv_impl="pallas" the 3x3 convs of a block run as kernel F
(ops/cuda/conv3x3.py) from `fused_min_l` (default 128, as JAX)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.conv3x3 import conv3x3_fused
from .layers import FUSED_MIN_L, ConvNHWC


class InstanceNorm2d(nn.Module):
    """InstanceNorm over the spatial axes of NHWC, affine, biased variance,
    float32 statistics and output."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        x = x.float()
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = x.var(dim=(1, 2), unbiased=False, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias


def instance_stats(y, norm: InstanceNorm2d):
    """InstanceNorm of y as the affine pair (inv, shift), each (B, C) float32:
    IN(y) = y * inv + shift (JAX `_InStats(return_affine=True)`)."""
    yf = y.float()
    mean = yf.mean(dim=(1, 2))
    var = yf.var(dim=(1, 2), unbiased=False)
    inv = norm.weight / torch.sqrt(var + norm.eps)
    return inv, norm.bias - mean * inv


def hwio(conv: ConvNHWC, dtype):
    """The conv's weight in the JAX layout (kh, kw, C_in, C_out), in dtype."""
    return conv.weight.to(dtype).permute(2, 3, 1, 0)


def conv_block_kernels(block, x, dilation: int):
    """The residual conv block on kernel F, in JAX's kernel-path form: conv ->
    IN statistics as (inv, shift) -> conv with the IN affine + ELU as its
    pre-op (or, under active dropout, applied before it) -> elu(x + y2 * inv2
    + shift2). `block` holds conv1, conv2, in1, in2, dropout and dtype. JAX's
    row tiling can refuse some L (`pick_tile` returns None) and falls back to
    the XLA conv there; kernel F takes every L, with the same result."""
    ct = block.dtype or torch.float32
    x = x.to(ct).contiguous()
    y1 = conv3x3_fused(x, hwio(block.conv1, ct), None, dilation, ct)
    inv1, shift1 = instance_stats(y1, block.in1)
    if block.training and block.dropout.p > 0:
        a = F.elu(y1.float() * inv1[:, None, None, :] + shift1[:, None, None, :])
        y2 = conv3x3_fused(block.dropout(a).to(ct), hwio(block.conv2, ct), None, dilation, ct)
    else:
        y2 = conv3x3_fused(y1, hwio(block.conv2, ct), (inv1, shift1), dilation, ct)
    inv2, shift2 = instance_stats(y2, block.in2)
    out = F.elu(x.float() + y2.float() * inv2[:, None, None, :] + shift2[:, None, None, :])
    return out.to(ct)


class ResBlock2D(nn.Module):
    """conv3x3(dilated) -> IN -> ELU -> Dropout -> conv3x3 -> IN, residual, ELU.

    With conv_impl="pallas" and H >= fused_min_l: `conv_block_kernels`."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: int = 1,
                 p_dropout: float = 0.15, dtype=None, conv_impl: str = "xla",
                 fused_min_l: int = FUSED_MIN_L):
        super().__init__()
        self.dtype, self.conv_impl = dtype, conv_impl
        self.kernel_size, self.dilation, self.fused_min_l = kernel_size, dilation, fused_min_l
        self.conv1 = ConvNHWC(channels, channels, kernel_size, dilation, dtype=dtype)
        self.conv2 = ConvNHWC(channels, channels, kernel_size, dilation, dtype=dtype)
        self.in1 = InstanceNorm2d(channels)
        self.in2 = InstanceNorm2d(channels)
        self.dropout = nn.Dropout(p_dropout)

    def forward(self, x):
        if (self.conv_impl == "pallas" and self.kernel_size == 3
                and x.shape[1] >= self.fused_min_l):
            return conv_block_kernels(self, x, self.dilation)
        y = self.dropout(F.elu(self.in1(self.conv1(x))))
        y = self.in2(self.conv2(y))
        out = F.elu(x.float() + y)
        return out if self.dtype is None else out.to(self.dtype)


class ResNet(nn.Module):
    """1x1 in-proj + IN + ELU; n blocks with dilations cycling (1, 2, 4, 8);
    1x1 out-proj with bias."""

    def __init__(self, n_res_blocks: int, in_channels: int, intermediate_channels: int,
                 out_channels: int, dilations=(1, 2, 4, 8), p_dropout: float = 0.15,
                 dtype=None, conv_impl: str = "xla"):
        super().__init__()
        self.dtype, self.n = dtype, n_res_blocks
        self.proj_in = ConvNHWC(in_channels, intermediate_channels, 1, dtype=dtype)
        self.in_in = InstanceNorm2d(intermediate_channels)
        for i in range(n_res_blocks):
            self.add_module(f"block_{i}", ResBlock2D(
                intermediate_channels, 3, dilations[i % len(dilations)], p_dropout,
                dtype=dtype, conv_impl=conv_impl))
        self.proj_out = ConvNHWC(intermediate_channels, out_channels, 1, bias=True)

    def forward(self, x):
        x = F.elu(self.in_in(self.proj_in(x)))
        if self.dtype is not None:
            x = x.to(self.dtype)
        for i in range(self.n):
            x = getattr(self, f"block_{i}")(x)
        return self.proj_out(x)
