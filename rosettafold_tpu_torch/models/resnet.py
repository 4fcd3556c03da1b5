"""2D dilated-conv ResNet on NHWC tensors (port of rosettafold_tpu/models/resnet.py,
unchunked). InstanceNorm: eps 1e-6, biased variance, float32 statistics."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import FUSED_MIN_L, ConvNHWC, require_unported


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


class ResBlock2D(nn.Module):
    """conv3x3(dilated) -> IN -> ELU -> Dropout -> conv3x3 -> IN, residual, ELU."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: int = 1,
                 p_dropout: float = 0.15, dtype=None, conv_impl: str = "xla"):
        super().__init__()
        self.dtype, self.conv_impl = dtype, conv_impl
        self.conv1 = ConvNHWC(channels, channels, kernel_size, dilation, dtype=dtype)
        self.conv2 = ConvNHWC(channels, channels, kernel_size, dilation, dtype=dtype)
        self.in1 = InstanceNorm2d(channels)
        self.in2 = InstanceNorm2d(channels)
        self.dropout = nn.Dropout(p_dropout)

    def forward(self, x):
        if self.conv_impl == "pallas" and x.shape[1] >= FUSED_MIN_L:
            require_unported("conv3x3", x.shape[1])
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
